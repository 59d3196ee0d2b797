"""VAE training step: multi-view reconstruction with per-LoD rendering, KL
annealing and the 2DGS geometry regularisers (port of
`gaussiananything_tpu/train/vae_trainer.py`, without the GAN path and
gradient accumulation).

`TrainLoop3DRecNVPatchSingleForwardMV_NoCrop` (`nsr/train_nv_util.py:
1771-3048`): the batch carries input views (15 channels) and supervision
views (rgb, alpha, depth); encode with FPS anchors → decode every LoD →
render each LoD at its own resolution (the release ladder 128/256/384/512,
`vit/vit_triplane.py:1605-1613`; `rand_coarse_lod` renders ONE random
coarse LoD and the finest, `:1550-1591`); losses per LoD (L1, alpha, the
perceptual term on one drawn LoD, scale-invariant depth), KL on the
bottleneck, normal and distortion regularisers on the finest render after
their start steps (`:2158-2175`), scale/opacity regularisers
(`:2143-2155`), optional chamfer supervision (`:2244-2246`).

The renders go through the differentiable rasterizer (`impl="cuda"`: the
training kernels on the card, their plain versions on the CPU). The step's
random draws come from a `torch.Generator` or are passed in (`draws`), so
two implementations can be fed the same noise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gaussiananything_tpu_torch.ops.pointcloud import chamfer_distance
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    TrainStateConfig,
                                                    global_norm)
from gaussiananything_tpu_torch.utils.image import resize


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    l1_weight: float = 1.0
    perceptual_weight: float = 0.5
    alpha_weight: float = 1.0
    depth_weight: float = 0.5
    kl_target: float = 1e-5
    kl_anneal_steps: int = 5000
    normal_weight: float = 0.05
    normal_start_step: int = 3500      # reference: 35k of 100k (`:2158`)
    dist_weight: float = 100.0
    dist_start_step: int = 1500        # reference: 15k (`:2167`)
    scale_reg_weight: float = 1.0
    opacity_reg_weight: float = 0.01
    chamfer_weight: float = 0.0
    # render resolution per LoD, coarse → fine; (128, 256, 384, 512) is
    # the release ladder
    lod_resolutions: Tuple[int, ...] = (64, 128, 192, 256)
    # supervise ONE random coarse LoD and the finest per step instead of
    # all LoDs (`vit/vit_triplane.py:1550-1591`)
    rand_coarse_lod: bool = False


class StageTimer:
    """Seconds per named stage of a step; each stage ends in a device
    synchronise so the host clock sees the device's work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self._t = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._t = self._now()

    def lap(self, stage: str):
        t = self._now()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + t - self._t
        self._t = t


def render_lods(lods: Sequence[torch.Tensor], cam_view: torch.Tensor,
                cam_view_proj: torch.Tensor, bg: torch.Tensor,
                resolutions: Sequence[int], max_per_tile: int = 1024,
                impl: str = "cuda", chunk: int = 128
                ) -> List[Dict[str, torch.Tensor]]:
    """Render each LoD at its ladder resolution: a list of the map dicts of
    `render_multiview`. chunk 128 is the training kernels' chunk."""
    B, V = cam_view.shape[:2]
    bg = bg.float().expand(B, V, 3)
    return [render_multiview(g, cam_view, cam_view_proj, bg, res, tile=16,
                             max_per_tile=max_per_tile, chunk=chunk,
                             impl=impl)
            for g, res in zip(lods, resolutions)]


def _resize_to(x: torch.Tensor, res: int) -> torch.Tensor:
    """(B, V, C, H, W) → antialiased bilinear resize to (res, res)."""
    if x.shape[-2] == res and x.shape[-1] == res:
        return x
    return resize(x, (res, res), "linear")


def draw_step_randomness(n_lod: int, cfg: VAELossConfig,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, Optional[int]]:
    """The step's discrete draws: which LoD gets the perceptual term and,
    under `rand_coarse_lod`, which coarse LoD is rendered. In that mode
    only {coarse_idx, finest} are rendered, so the perceptual draw is
    between those two."""
    def randint(n):
        return int(torch.randint(0, n, (), generator=generator))

    if cfg.rand_coarse_lod and n_lod > 2:
        coarse_idx = randint(n_lod - 1)
        lpips_lod = n_lod - 1 if randint(2) else coarse_idx
        return {"coarse_idx": coarse_idx, "lpips_lod": lpips_lod}
    return {"coarse_idx": None, "lpips_lod": randint(n_lod)}


def vae_loss_fn(model, batch: Dict[str, torch.Tensor], step: int,
                cfg: VAELossConfig,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None, perceptual_net=None,
                timer: Optional[StageTimer] = None):
    """Returns (total, (logs, renders, lods)).

    batch: images_in (B, V_in, 15, H, W); pcd (B, P, 3); cam_view and
    cam_view_proj (B, V_sup, 4, 4); tanfov scalar; images_sup (B, V_sup, 3,
    H, W); alpha_sup and optionally depth_sup (B, V_sup, 1, H, W).

    draws: optional {"noise": (B, K, z) latent noise, "lpips_lod": int,
    "coarse_idx": int}; what is absent is drawn from `generator`, a CPU
    generator (the noise is drawn on the host and moved to the batch's
    device, so a seed gives the same step on the card and on the CPU).
    """
    draws = dict(draws or {})
    dev = batch["images_in"].device
    if "noise" not in draws:
        draws["noise"] = torch.randn(
            (batch["images_in"].shape[0],) + model.latent_shape,
            generator=generator)
    out = model(batch["images_in"], batch["pcd"],
                noise=draws["noise"].to(dev))
    lods = out["lods"]
    n_lod = len(lods)
    if "lpips_lod" not in draws:
        draws.update(draw_step_randomness(n_lod, cfg, generator))
    lpips_lod, coarse_idx = draws["lpips_lod"], draws.get("coarse_idx")
    bg = torch.ones(3, dtype=torch.float32, device=dev)
    if timer:
        timer.lap("forward")

    logs: Dict[str, torch.Tensor] = {}

    def lod_loss(rend, res, i, log=True):
        gt_img = _resize_to(batch["images_sup"], res)
        gt_alpha = _resize_to(batch["alpha_sup"], res)
        rec = L.l1(rend["image"], gt_img)
        al = L.mse(rend["alpha"], gt_alpha)
        sub = cfg.l1_weight * rec + cfg.alpha_weight * al
        if log:
            logs[f"l1_lod{i}"] = rec
            logs[f"alpha_lod{i}"] = al
        if cfg.perceptual_weight > 0:
            # the pyramid runs only for the drawn LoD
            p = L.perceptual_loss(rend["image"].flatten(0, 1),
                                  gt_img.flatten(0, 1), perceptual_net) \
                if lpips_lod == i else torch.zeros((), device=dev)
            sub = sub + cfg.perceptual_weight * p
            if log:
                logs[f"lpips_lod{i}"] = p
        if "depth_sup" in batch and cfg.depth_weight > 0:
            dl = L.depth_loss_scale_invariant(
                rend["depth"], _resize_to(batch["depth_sup"], res), gt_alpha)
            sub = sub + cfg.depth_weight * dl
            if log:
                logs[f"depth_lod{i}"] = dl
        if timer:
            timer.lap("loss")
        return sub

    def render(idx: Sequence[int]):
        rends = render_lods([lods[i] for i in idx], batch["cam_view"],
                            batch["cam_view_proj"], bg,
                            [cfg.lod_resolutions[i] for i in idx])
        if timer:
            timer.lap("render")
        return rends

    total = 0.0
    if cfg.rand_coarse_lod and n_lod > 2:
        coarse = lod_loss(render([coarse_idx])[0],
                          cfg.lod_resolutions[coarse_idx], coarse_idx,
                          log=False)
        logs["coarse_lod_loss"] = coarse
        renders = render([n_lod - 1])
        total = coarse + lod_loss(renders[-1],
                                  cfg.lod_resolutions[n_lod - 1], n_lod - 1)
    else:
        renders = render(range(n_lod))
        for i, rend in enumerate(renders):
            total = total + lod_loss(rend, cfg.lod_resolutions[i], i)

    kl = out["kl"].mean()
    total = total + L.kl_coeff_schedule(step, cfg.kl_target,
                                        cfg.kl_anneal_steps) * kl
    logs["kl"] = kl

    # 2DGS geometry regularisers on the finest render, gated by step. The
    # EXPECTED depth feeds the depth → normal surface, as in the reference
    # (`utils/point_utils.py:11,65`); the depth losses above use the median
    fin = renders[-1]
    dist = fin["dist"].mean()
    total = total + cfg.dist_weight * float(step >= cfg.dist_start_step) \
        * dist
    logs["dist"] = dist
    surf_n = L.depth_to_normal(fin["depth_expected"], batch["cam_view"],
                               batch["tanfov"])
    nl = L.normal_consistency_loss(fin["rend_normal"], surf_n, fin["alpha"])
    total = total + cfg.normal_weight \
        * float(step >= cfg.normal_start_step) * nl
    logs["normal"] = nl

    total = total + cfg.scale_reg_weight * L.scale_reg(lods[-1]) \
        + cfg.opacity_reg_weight * L.opacity_reg(lods[-1])
    with torch.no_grad():
        op = lods[-1][..., 3]
        sc = lods[-1][..., 4:6]
        logs["opacity_mean"] = op.mean()
        logs["opacity_p95"] = torch.quantile(op.flatten(), 0.95)
        logs["scale_mean"] = sc.mean()
        logs["scale_max"] = sc.max()

    if cfg.chamfer_weight > 0:
        cd = chamfer_distance(lods[-1][..., :3], batch["pcd"]).mean()
        total = total + cfg.chamfer_weight * cd
        logs["chamfer"] = cd

    logs["total"] = total
    if timer:
        timer.lap("loss")
    return total, (logs, renders, lods)


def make_train_step(model, cfg: VAELossConfig,
                    tx_cfg: Optional[TrainStateConfig] = None,
                    perceptual_net=None) -> Callable:
    """Returns train_step(state, batch, generator=None, draws=None,
    timer=None) → logs (detached scalars, `grad_norm` among them): loss,
    gradients, the optimiser and EMA updates of `state` (in place)."""
    tx_cfg = tx_cfg or TrainStateConfig()

    def train_step(state: TrainState, batch, generator=None, draws=None,
                   timer: Optional[StageTimer] = None):
        if timer:
            timer.start()
        total, (logs, _, _) = vae_loss_fn(
            model, batch, state.step, cfg, generator=generator, draws=draws,
            perceptual_net=perceptual_net, timer=timer)
        names = list(state.params)
        grads = torch.autograd.grad(total, [state.params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if timer:
            timer.lap("backward")
        logs = {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                for k, v in logs.items()}
        logs["grad_norm"] = global_norm(grads)
        state.apply_gradients(grads, tx_cfg)
        if timer:
            timer.lap("optimizer")
        return logs

    return train_step
