"""Camera math (port of `gaussiananything_tpu/render/cameras.py`).

Conventions, identical to the reference so poses interoperate:
  * camera matrices are ROW-VECTOR style: ``x_clip = [x_world, 1] @ M``;
  * OpenGL-style projection with z mapped to [0, zfar/(zfar-znear)];
  * 25-dim flat poses = 16 (c2w, row-major) + 9 (K, row-major);
  * znear = 0.01, zfar = 100.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from gaussiananything_tpu_torch.utils.precision import (highest_einsum,
                                                        highest_inv,
                                                        highest_matmul)
from gaussiananything_tpu_torch.utils.quaternions import rotmat_to_quat

ZNEAR = 0.01
ZFAR = 100.0


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels: float = 1.0):
    return 2 * torch.atan2(torch.full_like(focal, pixels), 2 * focal)


def world2view(c2w: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) camera-to-world -> ROW-VECTOR world-to-view transform
    M, x_view = [x_world, 1] @ M (`getWorld2View2(R, t).T` of the
    reference); the inverse in IEEE fp32."""
    return highest_inv(c2w).transpose(-1, -2)


def projection_matrix(znear: float = ZNEAR, zfar: float = ZFAR,
                      fov_x: float = math.radians(30.0),
                      fov_y: float | None = None) -> torch.Tensor:
    """Row-vector perspective projection (transpose of the reference's
    `getProjectionMatrix`, `utils/gs_utils/graphics_utils.py:65-88`)."""
    if fov_y is None:
        fov_y = fov_x
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fov_x / 2)
    P[1, 1] = 1.0 / math.tan(fov_y / 2)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = 1.0
    P[3, 2] = -(zfar * znear) / (zfar - znear)
    return torch.from_numpy(P)


def pose_to_gs_camera(pose25, znear: float = ZNEAR, zfar: float = ZFAR,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """25-dim flat pose(s) (..., 25) -> render camera dict with cam_view,
    cam_view_proj (..., 4, 4), cam_pos (..., 3), tanfov (...,),
    source_cv2wT_quat (..., 4) and orig_c2w (..., 4, 4)."""
    pose25 = torch.as_tensor(pose25, dtype=torch.float32, device=device)
    batch = pose25.shape[:-1]
    c2w = pose25[..., :16].reshape(batch + (4, 4))
    fx = pose25[..., 16]
    fov = focal2fov(fx)
    tanfov = torch.tan(fov / 2)

    cam_view = world2view(c2w)
    inv_tan = 1.0 / tanfov
    zeros = torch.zeros_like(inv_tan)
    ones = torch.ones_like(inv_tan)
    zz = ones * (zfar / (zfar - znear))
    zw = ones * (-(zfar * znear) / (zfar - znear))
    proj = torch.stack([
        torch.stack([inv_tan, zeros, zeros, zeros], -1),
        torch.stack([zeros, inv_tan, zeros, zeros], -1),
        torch.stack([zeros, zeros, zz, ones], -1),
        torch.stack([zeros, zeros, zw, zeros], -1),
    ], dim=-2)
    return {
        "cam_view": cam_view,
        "cam_view_proj": highest_matmul(cam_view, proj),
        "cam_pos": c2w[..., :3, 3],
        "tanfov": tanfov,
        "source_cv2wT_quat": rotmat_to_quat(
            c2w[..., :3, :3].transpose(-1, -2)),
        "orig_c2w": c2w,
    }


def plucker_rays(c2w: torch.Tensor, K: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """Per-pixel Plücker embedding (cross(o, d) ‖ d, 6 channels) from pose
    and normalised intrinsics (`datasets/g_buffer_objaverse.py:189-226,
    256-261`). c2w (..., 4, 4); K (..., 3, 3) with cx, cy in [0, 1].
    Returns (..., 6, h, w)."""
    dev = c2w.device
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    yy, xx = torch.meshgrid(y, x, indexing="ij")            # (h, w)
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    dirs_cam = torch.stack([(xx - cx) / fx, (yy - cy) / fy,
                            torch.ones_like(xx) * torch.ones_like(cx)], -1)
    d = highest_einsum("...hwj,...ij->...hwi", dirs_cam,
                       c2w[..., :3, :3])
    d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-16)
    o = c2w[..., None, None, :3, 3].expand_as(d)
    plucker = torch.cat([torch.linalg.cross(o, d), d], dim=-1)
    return plucker.movedim(-1, -3)


def intrinsics_from_fov(fov_deg: float = 30.0) -> np.ndarray:
    focal = 0.5 / math.tan(math.radians(fov_deg) / 2)
    return np.array([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]],
                    dtype=np.float32)


def look_at(cam_pos: np.ndarray, target: np.ndarray | None = None,
            up: Sequence[float] = (0.0, 0.0, 1.0)) -> np.ndarray:
    """z-up look-at camera-to-world, OpenCV-style frame (x right, y down,
    z forward), as `generate_input_camera` (`nsr/camera_utils.py:197`)."""
    if target is None:
        target = np.zeros(3, dtype=np.float32)
    forward = target - cam_pos
    forward = forward / (np.linalg.norm(forward) + 1e-8)
    up = np.asarray(up, dtype=np.float32)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right) + 1e-8
    cam_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = -cam_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = cam_pos
    return c2w


def generate_input_camera(r: float, poses_deg: Sequence[Tuple[float, float]],
                          fov_deg: float = 30.0) -> np.ndarray:
    """(elevation, azimuth) degrees at radius r -> (V, 25) flat poses."""
    K = intrinsics_from_fov(fov_deg).reshape(-1)
    out = []
    for elev, azi in poses_deg:
        elev_r, azi_r = math.radians(elev), math.radians(azi)
        pos = np.array([r * math.cos(elev_r) * math.cos(azi_r),
                        r * math.cos(elev_r) * math.sin(azi_r),
                        r * math.sin(elev_r)], dtype=np.float32)
        out.append(np.concatenate([look_at(pos).reshape(-1), K]))
    return np.stack(out).astype(np.float32)


def uni_mesh_path(n_azimuths: int = 10, radius: float = 1.8,
                  fov_deg: float = 30.0) -> np.ndarray:
    """5 elevations × n azimuths sweep (`nsr/camera_utils.py:233`)."""
    elevations = [0, -30, 30, -60, 60]
    poses = [(e, a) for e in elevations
             for a in np.linspace(0, 360, n_azimuths, endpoint=False)]
    return generate_input_camera(radius, poses, fov_deg)


def sample_uniform_cameras_on_sphere(rng: np.random.Generator, n: int,
                                     radius: float = 1.8,
                                     fov_deg: float = 30.0) -> np.ndarray:
    """Uniform sphere sampling (`nsr/camera_utils.py:268`)."""
    z = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    elev = np.degrees(np.arcsin(z))
    azi = np.degrees(phi)
    return generate_input_camera(radius, list(zip(elev, azi)), fov_deg)
