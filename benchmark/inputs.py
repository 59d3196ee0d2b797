"""The benchmark's own inputs, made from the seed on the device: the
conditioning images (a procedural object on white) and the noise."""
from __future__ import annotations

import math

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + 104729 * stream) % (2 ** 63))
    return g


def object_images(n: int, size: int, gen: torch.Generator, device,
                  blobs: int = 6) -> torch.Tensor:
    """(n, 3, size, size) images in [0, 1]: `blobs` shaded ellipsoids of
    random colour, placement and size over a white background, drawn
    front to back, the same amount of work for every seed."""
    u = torch.rand((n, blobs, 9), generator=gen, device=device)
    ys = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) \
        / size * 2 - 1
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    img = torch.ones((n, 3, size, size), device=device)
    depth = torch.full((n, 1, size, size), math.inf, device=device)
    for b in range(blobs):
        p = u[:, b]
        cx, cy = (p[:, 0] - 0.5)[:, None, None], (p[:, 1] - 0.5)[:, None, None]
        rx = (0.15 + 0.3 * p[:, 2])[:, None, None]
        ry = (0.15 + 0.3 * p[:, 3])[:, None, None]
        rot = (p[:, 4] * math.pi)[:, None, None]
        dx, dy = xx[None] - cx, yy[None] - cy
        a = (dx * torch.cos(rot) + dy * torch.sin(rot)) / rx
        c = (-dx * torch.sin(rot) + dy * torch.cos(rot)) / ry
        r2 = a * a + c * c
        inside = (r2 < 1)[:, None]
        h = torch.sqrt(torch.clamp(1 - r2, min=0))[:, None]
        z = p[:, 5][:, None, None, None] - 0.3 * h
        shade = 0.35 + 0.65 * h * (0.6 + 0.4 * (a - c)[:, None].clamp(-1, 1))
        col = p[:, 6:9][..., None, None] * shade
        front = inside & (z < depth)
        img = torch.where(front, col.clamp(0, 1), img)
        depth = torch.where(front, z, depth)
    return img


def _look_at(pos: torch.Tensor) -> torch.Tensor:
    """(V, 3) camera positions → (V, 4, 4) camera-to-world towards the
    origin, z up (x right, y down, z forward)."""
    fwd = -pos / pos.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=pos.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / right.norm(dim=-1, keepdim=True)
    cam_up = torch.linalg.cross(right, fwd)
    c2w = torch.eye(4, device=pos.device).repeat(pos.shape[0], 1, 1)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2] = right, -cam_up, fwd
    c2w[:, :3, 3] = pos
    return c2w


def gbuffer_instance(gen: torch.Generator, views: int, res: int,
                     n_points: int, device, spheres: int = 5,
                     radius: float = 1.8, fov_deg: float = 30.0) -> dict:
    """One procedural object, `spheres` coloured spheres, seen from
    `views` cameras on a sphere of `radius` (elevations -30..60): each
    view ray-cast exactly at `res`² (rgb shaded by the normal, world
    normals, view-space depth, alpha), the poses as 25 numbers (c2w and
    normalised intrinsics) and `n_points` points on the surfaces."""
    u = torch.rand((spheres, 7), generator=gen, device=device)
    cen = (u[:, :3] - 0.5) * 0.5
    rad = 0.08 + 0.12 * u[:, 3]
    col = 0.15 + 0.85 * u[:, 4:7]
    a = torch.rand((views, 2), generator=gen, device=device)
    elev = torch.deg2rad(-30 + 90 * a[:, 0])
    azi = 2 * math.pi * a[:, 1]
    pos = radius * torch.stack([torch.cos(elev) * torch.cos(azi),
                                torch.cos(elev) * torch.sin(azi),
                                torch.sin(elev)], -1)
    c2w = _look_at(pos)
    focal = 0.5 / math.tan(math.radians(fov_deg) / 2)
    tanfov = 1.0 / (2 * focal)
    g = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) \
        / res * 2 - 1
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    d_cam = torch.stack([gx * tanfov, gy * tanfov, torch.ones_like(gx)], -1)
    d = torch.einsum("hwj,vij->vhwi", d_cam, c2w[:, :3, :3])  # z-scaled
    o = c2w[:, None, None, :3, 3]
    best = torch.full(d.shape[:-1], math.inf, device=device)
    nrm = torch.zeros_like(d)
    rgb = torch.ones_like(d)
    for s in range(spheres):
        oc = o - cen[s]
        A = (d * d).sum(-1)
        B = 2 * (oc * d).sum(-1)
        C = (oc * oc).sum(-1) - rad[s] ** 2
        disc = B * B - 4 * A * C
        t = (-B - torch.sqrt(torch.clamp(disc, min=0))) / (2 * A)
        hit = (disc > 0) & (t > 0) & (t < best)
        p = o + t[..., None] * d
        n = (p - cen[s]) / rad[s]
        shade = 0.4 + 0.6 * torch.clamp(-(n * d).sum(-1)
                                        / d.norm(dim=-1), 0, 1)
        best = torch.where(hit, t, best)
        nrm = torch.where(hit[..., None], n, nrm)
        rgb = torch.where(hit[..., None], col[s] * shade[..., None], rgb)
    alpha = torch.isfinite(best).float()
    depth = torch.where(alpha > 0, best, torch.zeros_like(best))
    K = torch.tensor([focal, 0, 0.5, 0, focal, 0.5, 0, 0, 1],
                     device=device).expand(views, 9)
    # points on the spheres, by area, keeping those no other sphere hides
    area = rad ** 2
    idx = torch.multinomial(area / area.sum(), 4 * n_points, True,
                            generator=gen)
    v = torch.randn((4 * n_points, 3), generator=gen, device=device)
    pts = cen[idx] + rad[idx, None] * v / v.norm(dim=-1, keepdim=True)
    inside = ((pts[:, None] - cen[None]).norm(dim=-1)
              < rad[None] - 1e-4).any(-1)
    pts = pts[~inside][:n_points]
    return {"rgb": rgb, "normal": nrm, "depth": depth, "alpha": alpha,
            "pose": torch.cat([c2w.reshape(views, 16), K], -1), "pcd": pts}


def write_gbuffer_set(out_dir: str, seed: int, instances: int, views: int,
                      res: int, n_points: int, device) -> list:
    """`instances` files in the packed G-buffer layout (uint8 rgb and
    alpha, fp16 normal and depth, fp32 poses and points), written without
    compression; returns their paths."""
    import os

    import numpy as np
    gen = generator(seed, 5, device)
    paths = []
    for i in range(instances):
        inst = {k: v.cpu().numpy() for k, v in gbuffer_instance(
            gen, views, res, n_points, device).items()}
        path = os.path.join(out_dir, f"{i:05d}.npz")
        np.savez(path, rgb=(inst["rgb"] * 255).astype(np.uint8),
                 normal=inst["normal"].astype(np.float16),
                 depth=inst["depth"].astype(np.float16),
                 alpha=(inst["alpha"] * 255).astype(np.uint8),
                 pose=inst["pose"].astype(np.float32),
                 pcd=inst["pcd"].astype(np.float32))
        paths.append(path)
    return paths
