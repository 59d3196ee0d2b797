"""Procedural multi-view data (port of
`gaussiananything_tpu/data/synthetic.py`): random surfel objects rendered
with the port's own rasterizer, in the training-batch schema of the real
g-buffer pipeline. Serves the demo conditioning image of `cli/sample.py`,
the kernel checks' scenes and the batches of `cli/train_vae.py`."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaussiananything_tpu_torch.data.postprocess import \
    assemble_encoder_input
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.utils.image import resize


def describe_object(seed: int, kind: str | None = None) -> str:
    """The caption of `make_object(seed)` (`synthetic.py:21`): it re-draws
    the same first choice, so the text names the geometry (the synthetic
    stand-in for the reference's Cap3D captions)."""
    rng = np.random.default_rng(seed)
    kind = kind or rng.choice(["sphere", "ellipsoid", "torus"])
    hue = ["red", "green", "blue", "yellow", "purple", "cyan"][seed % 6]
    return f"a {hue} {kind}"


def make_object(seed: int, n: int = 1024, kind: str | None = None,
                device="cpu") -> torch.Tensor:
    """Random surfel object (N, 13) fp32: a sphere / ellipsoid / torus shell
    with smooth position-derived colours (`synthetic.py:31`, same draws)."""
    rng = np.random.default_rng(seed)
    kind = kind or rng.choice(["sphere", "ellipsoid", "torus"])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if kind == "sphere":
        xyz = 0.35 * d
        nrm = d
    elif kind == "ellipsoid":
        ax = rng.uniform(0.15, 0.4, 3)
        xyz = d * ax
        nrm = d / ax
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    else:
        theta = rng.uniform(0, 2 * np.pi, n)
        phi = rng.uniform(0, 2 * np.pi, n)
        R, r = 0.28, 0.12
        xyz = np.stack([(R + r * np.cos(phi)) * np.cos(theta),
                        (R + r * np.cos(phi)) * np.sin(theta),
                        r * np.sin(phi)], 1)
        nrm = np.stack([np.cos(phi) * np.cos(theta),
                        np.cos(phi) * np.sin(theta), np.sin(phi)], 1)
    # quaternion rotating +z to nrm
    z = np.array([0.0, 0, 1])
    v = np.cross(z, nrm)
    c = nrm @ z
    q = np.concatenate([(1 + c)[:, None], v], 1)
    q_norm = np.linalg.norm(q, axis=1, keepdims=True)
    q[q_norm[:, 0] < 1e-6] = np.array([0.0, 1, 0, 0])
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-8)
    base = rng.uniform(0.2, 1.0, 3)
    rgb = np.clip(base[None] * (0.6 + 0.4 * (xyz / 0.4 + 1) / 2), 0, 1)
    scale = np.full((n, 2), 2.2 * np.sqrt(1.0 / n) * 0.6)
    g = np.concatenate([xyz, np.full((n, 1), 0.95), scale, q, rgb], 1)
    return torch.as_tensor(g.astype(np.float32), device=device)


def render_scene_views(gaussians: torch.Tensor, poses25: np.ndarray,
                       res: int = 128) -> Dict[str, torch.Tensor]:
    """Render (V, 25) poses → channel-first maps (V leading), on the
    gaussians' device (`synthetic.py:77`).

    A `res` that is not a multiple of 16 (the DINOv2 size 518) is rendered
    at the nearest multiple and resized: bicubic for the image (the
    conditioning consumer), linear for the geometry maps, as the reference's
    render-512 → resize-518 path (`sgm/modules/encoders/modules.py:863-875`).
    """
    rres = max(16, int(round(res / 16)) * 16)
    dev = gaussians.device
    cam = cameras.pose_to_gs_camera(poses25, device=dev)
    V = poses25.shape[0]
    out = render_multiview(
        gaussians[None], cam["cam_view"][None], cam["cam_view_proj"][None],
        torch.ones((1, V, 3), device=dev), rres, tile=16, max_per_tile=512,
        chunk=128)
    out = {k: v[0] for k, v in out.items()}
    if rres != res:
        out = {k: resize(v, (res, res),
                         "cubic" if k == "image" else "linear")
               for k, v in out.items()}
        out["alpha"] = torch.clamp(out["alpha"], 0.0, 1.0)
    return out


def make_batch(seed: int, batch: int = 1, n_views_in: int = 4,
               n_views_sup: int = 4, res: int = 128, n_pts: int = 1024,
               n_splats: int = 1024, device="cpu") -> Dict[str, torch.Tensor]:
    """A full VAE-trainer batch for `vae_loss_fn`, plus the ground-truth
    gaussians (`synthetic.py:108`, the same numpy draws, so both packages
    make the same batch from a seed). The ground-truth views render
    through the forward-only rasterizer."""
    rng = np.random.default_rng(seed)
    items = []
    for b in range(batch):
        g = make_object(seed * 131 + b, n=n_splats, device=device)
        elevs = rng.uniform(-30, 60, n_views_in + n_views_sup)
        azis = rng.uniform(0, 360, n_views_in + n_views_sup)
        poses = cameras.generate_input_camera(1.8, list(zip(elevs, azis)))
        maps = render_scene_views(g, poses, res)
        poses_t = torch.as_tensor(poses, device=device)
        imgs_in = assemble_encoder_input(
            maps["image"][None, :n_views_in],
            maps["rend_normal"][None, :n_views_in],
            maps["depth"][None, :n_views_in],
            maps["alpha"][None, :n_views_in], poses_t[None, :n_views_in])
        sup = slice(n_views_in, n_views_in + n_views_sup)
        cam = cameras.pose_to_gs_camera(poses[sup], device=device)
        # surface point cloud = splat centres (stands in for the FPS file)
        idx = rng.choice(g.shape[0], n_pts, replace=n_pts > g.shape[0])
        items.append({
            "images_in": imgs_in[0],
            "pcd": g[torch.as_tensor(idx, device=device), :3],
            "cam_view": cam["cam_view"],
            "cam_view_proj": cam["cam_view_proj"],
            "cam_pos": cam["cam_pos"],
            "images_sup": maps["image"][sup],
            "alpha_sup": maps["alpha"][sup],
            "depth_sup": maps["depth"][sup],
            "gt_gaussians": g,
        })
    out = {k: torch.stack([it[k] for it in items]) for k in items[0]}
    out["tanfov"] = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(0, 0)])[0],
        device=device)["tanfov"]
    return out
