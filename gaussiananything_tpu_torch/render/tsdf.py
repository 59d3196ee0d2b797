"""TSDF fusion and mesh extraction (port of
`gaussiananything_tpu/render/tsdf.py`).

`export_mesh_from_2dgs` / `extract_mesh_bounded` parity
(`nsr/lsgm/flow_matching_trainer.py:1244-1395`, `utils/mesh_util.py:22`):
render median depth, color and alpha along the `uni_mesh_path` sweep
(`n_views` azimuths at 5 elevations),
integrate them into a truncated signed distance volume (voxel =
2·bound/D, sdf_trunc = 12 voxels, alpha threshold 0.08, bound 0.495 =
0.45·1.1), then extract a colored triangle mesh by surface nets.

`integrate_tsdf` is plain PyTorch on the caller's device, vectorised over
the D³ voxels with a loop over the views; the native OpenMP integrate
(`native_bindings.tsdf_integrate`) computes the same function on the host
and is held to it by the tests. The mesh is extracted by the native
surface nets; `surface_nets` here is their plain NumPy version.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def integrate_tsdf(depths: torch.Tensor, colors: torch.Tensor,
                   alphas: torch.Tensor, cam_view: torch.Tensor,
                   tanfov: float, resolution: int = 128,
                   bound: float = 0.495, trunc_voxels: float = 12.0,
                   alpha_thres: float = 0.08
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse V views into (tsdf (D,D,D), color (3,D,D,D)), fp32, on the
    inputs' device.

    depths/alphas (V, 1, H, W); colors (V, 3, H, W); cam_view (V, 4, 4)
    row-vector world→view transforms; tanfov a scalar. Each voxel centre is
    projected into every view, the depth, alpha and color are sampled
    bilinearly (edge-clamped, Open3D's image sampling), and a voxel a view
    sees (inside the image, alpha above the threshold, depth above 0.05)
    within the truncation in front of the surface updates running means of
    the clipped SDF and the color.
    """
    dev = depths.device
    D = resolution
    trunc = trunc_voxels * (2 * bound / D)
    lin = (torch.arange(D, dtype=torch.float32, device=dev) + 0.5) / D \
        * 2 * bound - bound
    gx, gy, gz = (g.reshape(-1) for g in
                  torch.meshgrid(lin, lin, lin, indexing="ij"))
    V, _, H, W = depths.shape
    tanfov = float(tanfov)
    n = D ** 3
    tsdf = torch.ones(n, device=dev)
    weight = torch.zeros(n, device=dev)
    color = torch.zeros((3, n), device=dev)
    for i in range(V):
        cv = cam_view[i].float()
        vx = gx * cv[0, 0] + gy * cv[1, 0] + gz * cv[2, 0] + cv[3, 0]
        vy = gx * cv[0, 1] + gy * cv[1, 1] + gz * cv[2, 1] + cv[3, 1]
        z = gx * cv[0, 2] + gy * cv[1, 2] + gz * cv[2, 2] + cv[3, 2]
        u = (vx / (z * tanfov) + 1) * 0.5 * W - 0.5
        v = (vy / (z * tanfov) + 1) * 0.5 * H - 0.5
        in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) \
            & (z > 0.05)
        u0, v0 = torch.floor(u), torch.floor(v)
        fu, fv = u - u0, v - v0
        # (a voxel outside the image samples a clamped corner, unused)
        u0i = u0.clamp(0, W - 1).long()
        v0i = v0.clamp(0, H - 1).long()
        u1i = (u0i + 1).clamp(max=W - 1)
        v1i = (v0i + 1).clamp(max=H - 1)
        flat = [v0i * W + u0i, v0i * W + u1i, v1i * W + u0i, v1i * W + u1i]
        wts = [(1 - fu) * (1 - fv), fu * (1 - fv), (1 - fu) * fv, fu * fv]

        def sample(img):
            img = img.reshape(-1).float()
            out = img[flat[0]] * wts[0]
            for f, w in zip(flat[1:], wts[1:]):
                out = out + img[f] * w
            return out

        d_px = sample(depths[i])
        a_px = sample(alphas[i])
        sdf = d_px - z
        seen = in_img & (a_px > alpha_thres) & (d_px > 0.05)
        w_new = (seen & (sdf > -trunc)).float()
        sdf_c = torch.clamp(sdf / trunc, -1.0, 1.0)
        new_w = weight + w_new
        inv_w = 1.0 / torch.clamp(new_w, min=1e-8)
        tsdf = (tsdf * weight + sdf_c * w_new) * inv_w
        cs = torch.stack([sample(colors[i, c]) for c in range(3)])
        color = (color * weight + cs * w_new) * inv_w
        weight = new_w
    tsdf = torch.where(weight > 0, tsdf, torch.ones_like(tsdf))
    return tsdf.reshape(D, D, D), color.reshape(3, D, D, D)


def surface_nets(tsdf: np.ndarray, color: Optional[np.ndarray] = None,
                 bound: float = 0.495
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Naive surface nets over a (D,D,D) SDF grid → (verts, faces, colors),
    NumPy: a vertex per cell with a sign change at the inverse-|SDF|
    weighted centroid of its corners, a quad (two triangles) per crossing
    grid edge."""
    D = tsdf.shape[0]
    voxel = 2 * bound / D
    sign = tsdf < 0
    c = sign[:-1, :-1, :-1]
    changed = np.zeros_like(c)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                changed |= sign[dx:D - 1 + dx, dy:D - 1 + dy,
                                dz:D - 1 + dz] != c
    cell_idx = -np.ones((D - 1,) * 3, np.int64)
    cells = np.argwhere(changed)
    if len(cells) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                None)
    cell_idx[tuple(cells.T)] = np.arange(len(cells))
    corners = np.stack([tsdf[cells[:, 0] + dx, cells[:, 1] + dy,
                             cells[:, 2] + dz]
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                       axis=1)                                      # (M, 8)
    offs = np.array([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                     for dz in (0, 1)], np.float32)
    w = 1.0 / (np.abs(corners) + 1e-4)
    centroid = (w[..., None] * offs[None]).sum(1) / w.sum(1)[:, None]
    verts = (cells + centroid + 0.5) * voxel - bound
    vcol = None
    if color is not None:
        ci = np.clip(np.round(cells + centroid).astype(np.int64), 0, D - 1)
        vcol = color[ci[:, 0], ci[:, 1], ci[:, 2]]
    faces = []
    for axis in range(3):
        sa = [slice(None)] * 3
        sa[axis] = slice(0, D - 1)
        sb = [slice(None)] * 3
        sb[axis] = slice(1, D)
        crossing = sign[tuple(sa)] != sign[tuple(sb)]
        flip = sign[tuple(sb)]
        a1, a2 = [a for a in range(3) if a != axis]
        edges = np.argwhere(crossing)
        keep = ((edges[:, a1] >= 1) & (edges[:, a1] <= D - 2)
                & (edges[:, a2] >= 1) & (edges[:, a2] <= D - 2)
                & (edges[:, axis] <= D - 2))
        edges = edges[keep]
        fl = flip[tuple(edges.T)]
        quad = []
        for o1, o2 in ((0, 0), (-1, 0), (-1, -1), (0, -1)):
            e = edges.copy()
            e[:, a1] += o1
            e[:, a2] += o2
            quad.append(cell_idx[tuple(e.T)])
        q = np.stack(quad, 1)                                   # (E, 4)
        ok = (q >= 0).all(1)
        q = q[ok]
        fl = fl[ok]
        q_f = np.where(fl[:, None], q[:, ::-1], q)
        faces.append(np.stack([q_f[:, 0], q_f[:, 1], q_f[:, 2]], 1))
        faces.append(np.stack([q_f[:, 0], q_f[:, 2], q_f[:, 3]], 1))
    return verts.astype(np.float32), np.concatenate(faces, 0), vcol


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def mesh_from_gaussians(gaussians: torch.Tensor, resolution: int = 128,
                        n_views: int = 10, render_size: int = 256,
                        radius: float = 1.8,
                        timings: Optional[Dict[str, float]] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, 13) gaussians → (verts, faces, vertex colors): the sweep's
    renders (through the rasterizer's forward kernel on the card: tile 16,
    max_per_tile 1024, chunk 256), the TSDF on the gaussians' device, the
    native surface nets. `timings` receives the seconds of "mesh render",
    "mesh integrate" and "mesh surface nets"."""
    from gaussiananything_tpu_torch import native_bindings
    from gaussiananything_tpu_torch.render import cameras
    from gaussiananything_tpu_torch.render.renderer import render_multiview

    dev = gaussians.device
    clock = {}
    t0 = time.perf_counter()
    poses = cameras.uni_mesh_path(n_views, radius)
    cam = cameras.pose_to_gs_camera(poses, device=dev)
    V = poses.shape[0]
    out = render_multiview(
        gaussians.float()[None], cam["cam_view"][None],
        cam["cam_view_proj"][None], torch.ones((1, V, 3), device=dev),
        render_size, tile=16, max_per_tile=1024, chunk=256)
    _sync(dev)
    t1 = time.perf_counter()
    clock["mesh render"] = t1 - t0
    tsdf, color = integrate_tsdf(out["depth"][0], out["image"][0],
                                 out["alpha"][0], cam["cam_view"],
                                 float(cam["tanfov"][0]),
                                 resolution=resolution)
    tsdf_np = tsdf.cpu().numpy()
    color_np = np.moveaxis(color.cpu().numpy(), 0, -1)
    t2 = time.perf_counter()
    clock["mesh integrate"] = t2 - t1
    verts, faces, vcol = native_bindings.surface_nets(tsdf_np, color_np)
    clock["mesh surface nets"] = time.perf_counter() - t2
    if timings is not None:
        timings.update(clock)
    return verts, faces, vcol


def write_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
               vcol: Optional[np.ndarray] = None):
    """A .obj (positions and faces) or else a .glb (with colors)."""
    if path.endswith(".obj"):
        with open(path, "w") as f:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for face in faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")
    else:
        from gaussiananything_tpu_torch.render.ply_io import save_mesh_glb
        save_mesh_glb(path, verts, faces, vcol)


def export_mesh_from_gaussians(path: str, gaussians: torch.Tensor,
                               resolution: int = 128, n_views: int = 10,
                               render_size: int = 256, radius: float = 1.8,
                               timings: Optional[Dict[str, float]] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """The whole export: `mesh_from_gaussians`, then `write_mesh`.
    Returns (verts, faces)."""
    verts, faces, vcol = mesh_from_gaussians(
        gaussians, resolution, n_views, render_size, radius, timings)
    write_mesh(path, verts, faces, vcol)
    return verts, faces
