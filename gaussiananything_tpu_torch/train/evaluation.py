"""Evaluation: image and geometry metrics, the novel-view evaluation of a
VAE and turntable export (port of
`gaussiananything_tpu/train/evaluation.py`).

The reference ships no metric code and validates by visual dumps
(`eval_novelview_loop`, `nsr/train_nv_util.py:2693`; `_make_vis_img`,
`nsr/lsgm/flow_matching_trainer.py:1636`): here PSNR, SSIM and the
perceptual distance, and the same dumps as PNGs (`utils/image.save_png`).
Every render runs without gradient, so on the card it takes the
forward-only kernel.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from gaussiananything_tpu_torch.ops.pointcloud import (chamfer_distance,
                                                       sinkhorn_emd)
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.train.vae_trainer import (_noise,
                                                          _resize_to,
                                                          render_lods)
from gaussiananything_tpu_torch.utils.image import save_png


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = ((a - b) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


@torch.no_grad()
def image_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, float]:
    """pred, gt (B, V, 3, H, W) in [0, 1]; the perceptual distance is the
    fallback pyramid's (`losses.default_perceptual_net`)."""
    p, g = pred.flatten(0, 1), gt.flatten(0, 1)
    return {"psnr": float(psnr(p, g)), "ssim": float(L.ssim(p, g)),
            "perceptual": float(L.perceptual_loss(p, g))}


@torch.no_grad()
def geometry_metrics(pred_xyz: torch.Tensor, gt_xyz: torch.Tensor,
                     f_thresh: float = 0.02) -> Dict[str, float]:
    """Single clouds pred (N, 3), gt (M, 3): symmetric chamfer, Sinkhorn
    EMD, and precision, recall and F-score at `f_thresh` world units (the
    share of points whose nearest neighbour in the other cloud is within
    it)."""
    cd = float(chamfer_distance(pred_xyz[None], gt_xyz[None])[0])
    emd = float(sinkhorn_emd(pred_xyz[None], gt_xyz[None])[0])
    d2 = ((pred_xyz[:, None, :] - gt_xyz[None, :, :]) ** 2).sum(-1)
    precision = float((d2.amin(1).sqrt() < f_thresh).float().mean())
    recall = float((d2.amin(0).sqrt() < f_thresh).float().mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"chamfer": cd, "emd": emd, "precision": precision,
            "recall": recall, "fscore": f1}


def _strip(images: np.ndarray) -> np.ndarray:
    """(V, 3, h, w) → one (h, V·w, 3) row."""
    return np.concatenate([np.moveaxis(v, 0, -1) for v in images], axis=1)


@torch.no_grad()
def eval_novelview(model, params: Dict[str, torch.Tensor], batch,
                   lod_resolutions: Sequence[int],
                   out_dir: Optional[str] = None, step: int = 0,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> Dict[str, float]:
    """Reconstruct the batch's supervision views with `model` under the
    weights `params` (e.g. `TrainState.ema`, through `functional_call`:
    the model's own parameters are neither read nor written) and measure
    the finest LoD against the ground truth. With `out_dir`, writes
    `eval_{step:07d}.png`: one row per LoD (upscaled to the finest size by
    index) and the ground truth, the first batch element's views. draws:
    optional {"noise"}, else drawn from `generator`."""
    out = functional_call(model, params, (batch["images_in"], batch["pcd"]),
                          {"noise": _noise(model, batch, generator, draws)})
    lods = out["lods"]
    bg = torch.ones(3, dtype=torch.float32, device=lods[-1].device)
    renders = render_lods(lods, batch["cam_view"], batch["cam_view_proj"],
                          bg, lod_resolutions[:len(lods)])
    res = lod_resolutions[len(lods) - 1]
    gt = _resize_to(batch["images_sup"], res)
    metrics = {f"eval/{k}": v for k, v in
               image_metrics(renders[-1]["image"], gt).items()}
    metrics["eval/kl"] = float(out["kl"].mean())
    metrics["eval/latent_std"] = float(out["mean"].std(correction=0))
    g = lods[-1]
    metrics["eval/opacity_mean"] = float(g[..., 3].mean())
    metrics["eval/scale_mean"] = float(g[..., 4:6].mean())

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        H = lod_resolutions[-1]
        rows = []
        for rend in renders:
            strip = _strip(rend["image"][0].cpu().numpy())
            if strip.shape[0] != H:
                # index gather: the ladder's 384 → 512 is not an integer
                # ratio
                W = strip.shape[1] * H // strip.shape[0]
                strip = strip[(np.arange(H) * strip.shape[0]) // H][
                    :, (np.arange(W) * strip.shape[1]) // W]
            rows.append(strip)
        rows.append(_strip(_resize_to(batch["images_sup"], H)[0]
                           .cpu().numpy()))
        grid = np.concatenate(rows, axis=0)
        save_png(os.path.join(out_dir, f"eval_{step:07d}.png"),
                 (np.clip(grid, 0, 1) * 255).astype(np.uint8))
    return metrics


@torch.no_grad()
def export_turntable(path: str, gaussians: torch.Tensor, n_frames: int = 24,
                     res: int = 256, radius: float = 1.8) -> str:
    """Render `gaussians` (N, 13) from `n_frames` azimuths at elevation 20°
    and write every (n_frames // 8)-th frame side by side as
    `<path without extension>.png` (the JAX package's fallback when no
    video writer is installed; `render_gs_video_given_latent`,
    `nsr/lsgm/flow_matching_trainer.py:1399`). Returns the PNG's path."""
    poses = cameras.generate_input_camera(
        radius, [(20, a) for a in np.linspace(0, 360, n_frames,
                                              endpoint=False)])
    cam = cameras.pose_to_gs_camera(poses, device=gaussians.device)
    out = render_multiview(
        gaussians[None], cam["cam_view"][None], cam["cam_view_proj"][None],
        torch.ones((1, n_frames, 3), device=gaussians.device), res, tile=16,
        max_per_tile=1024, chunk=256)
    frames = [(np.clip(np.moveaxis(v, 0, -1), 0, 1) * 255).astype(np.uint8)
              for v in out["image"][0].cpu().numpy()]
    png = os.path.splitext(path)[0] + ".png"
    save_png(png, np.concatenate(frames[::max(1, n_frames // 8)], axis=1))
    return png
