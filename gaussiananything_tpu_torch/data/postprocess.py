"""Assembly of the 15-channel encoder input and the frame-0 pose
canonicalisation (port of `gaussiananything_tpu/data/postprocess.py`).

The reference dataset's `PostProcess`
(`datasets/g_buffer_objaverse.py:109,189-261`): per view, rgb (3,
imagenet-normalised) ‖ normal (3) ‖ Plücker rays (6) ‖ world xyz (3); depth
maps are backprojected with the camera and masked pixels get xyz = 0.
The backprojection, the pose rebase and the point move are IEEE fp32
whatever the policy (`utils/precision.highest_*`, JAX's
`Precision.HIGHEST`); `fixed @ inv(c2w)` is a plain product, at the
process policy, as JAX's plain `@` is at `Precision.DEFAULT`.
"""
from __future__ import annotations

import torch

from gaussiananything_tpu_torch.render import cameras as cam_mod
from gaussiananything_tpu_torch.utils.precision import (highest_einsum,
                                                        highest_inv,
                                                        highest_matmul)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def backproject_depth(depth: torch.Tensor, c2w: torch.Tensor,
                      tanfov: torch.Tensor) -> torch.Tensor:
    """depth (..., 1, H, W), c2w (..., 4, 4), tanfov scalar or (...,) →
    world xyz (..., 3, H, W)."""
    H, W = depth.shape[-2:]
    dev = depth.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2 - 1
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    tf = torch.as_tensor(tanfov, dtype=torch.float32, device=dev) \
        .expand(depth.shape[:-3])[..., None, None]
    z = depth[..., 0, :, :]
    pts_view = torch.stack([gx * tf * z, gy * tf * z, z], dim=-1)
    pts_world = highest_einsum("...hwj,...ij->...hwi", pts_view,
                               c2w[..., :3, :3]) \
        + c2w[..., None, None, :3, 3]
    return pts_world.movedim(-1, -3)


def assemble_encoder_input(rgb: torch.Tensor, normal: torch.Tensor,
                           depth: torch.Tensor, alpha: torch.Tensor,
                           pose25: torch.Tensor) -> torch.Tensor:
    """(B, V, 3/3/1/1, H, W) maps and (B, V, 25) poses → (B, V, 15, H, W)."""
    B, V, _, H, W = rgb.shape
    mean = rgb.new_tensor(IMAGENET_MEAN).reshape(1, 1, 3, 1, 1)
    std = rgb.new_tensor(IMAGENET_STD).reshape(1, 1, 3, 1, 1)
    c2w = pose25[..., :16].reshape(B, V, 4, 4)
    K = pose25[..., 16:].reshape(B, V, 3, 3)
    plucker = cam_mod.plucker_rays(c2w, K, H, W)
    tanfov = torch.tan(cam_mod.focal2fov(pose25[..., 16]) / 2)
    xyz = backproject_depth(depth, c2w, tanfov) * (alpha > 0.5)
    return torch.cat([(rgb - mean) / std, normal, plucker, xyz], dim=2)


def _canonical_transform(c2w: torch.Tensor) -> torch.Tensor:
    """F @ inv(c2w) with F = eye(4) but F[2, 3] = −|t|: sends the camera
    c2w to identity rotation on −z at its own radius."""
    fixed = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
    fixed[2, 3] = -torch.linalg.vector_norm(c2w[:3, 3])
    return fixed @ highest_inv(c2w)


def canonicalize_poses(pose25: torch.Tensor, canonical_idx: int = 0
                       ) -> torch.Tensor:
    """Rebase a chunk's (V, 25) poses so view `canonical_idx` becomes the
    canonical camera; the same rigid transform applies to every view, K
    passes through (`normalize_camera(for_encoder=False)`,
    `datasets/g_buffer_objaverse.py:355-399`)."""
    V = pose25.shape[0]
    c2w = pose25[:, :16].reshape(V, 4, 4)
    new_c2w = highest_matmul(_canonical_transform(c2w[canonical_idx]),
                             c2w)
    return torch.cat([new_c2w.reshape(V, 16), pose25[:, 16:]], dim=-1)


def canonicalize_pts(pose25: torch.Tensor, pcd: torch.Tensor,
                     canonical_idx: int = 0) -> torch.Tensor:
    """Move a world-space point cloud (..., N, 3) by the transform
    `canonicalize_poses` applies to the cameras
    (`datasets/g_buffer_objaverse.py:291-321`)."""
    t = _canonical_transform(pose25[canonical_idx, :16].reshape(4, 4))
    return highest_matmul(pcd, t[:3, :3].T) + t[:3, 3]
