"""Release-scale VAE training step on one card (port of
`tools/release_feasibility.py`).

    python -m gaussiananything_tpu_torch.tools.release_feasibility \\
        [--views 4] [--steps 5] [--bf16] [--device cuda]

The JAX tool's recipe: the full `vae` preset (768 latents, a 768 x 12
DiT2 decoder, upsamplers to 73,728 surfels), batch 1 of 4 input views and
`--views` supervised views at 512² from `data.synthetic.make_batch(seed=0,
n_pts=4096, n_splats=4096)`, the (128, 256, 384, 512) ladder with
`rand_coarse_lod` (one random coarse LoD and the finest per step), each
render checkpointed (`render_lods(remat=True)`, the trainer's default), lr
1e-4 after a 10-step warm-up. It mirrors the reference's release recipe
(`shell_scripts/release/train/stage-1-vae3d/vae3d-adv-512.sh:24-33`: 512²,
8 supervised views, bf16 AMP) at one card's batch. `--bf16` sets
`vae.compute_dtype` to "bfloat16": the products in bf16, the parameters,
optimiser moments and EMA fp32 (`models/layers.py`).

Prints the parameter count, the first step's seconds (the kernels are
built before it), the steady step's milliseconds and steps/s (the mean of
`--steps` steps, one synchronise at their end) and the peak device memory
(`torch.cuda.max_memory_allocated`), then one JSON line of them with the
card's name and power limit. `feasibility`'s other arguments take a
smaller model and scene.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import torch

from gaussiananything_tpu_torch.config import preset
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    TrainStateConfig)
from gaussiananything_tpu_torch.train.vae_trainer import (VAELossConfig,
                                                          make_train_step)
from gaussiananything_tpu_torch.utils.device import resolve_device

TAG = "RELEASE-FEASIBILITY "
LADDER = (128, 256, 384, 512)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def feasibility(views: int = 4, steps: int = 5, bf16: bool = False,
                device="cuda", vae_cfg=None, res: int = 512,
                lod_resolutions: Sequence[int] = LADDER,
                n_points: int = 4096,
                log: Callable[[str], None] = print) -> dict:
    """One first step and `steps` steady steps of the release VAE step;
    returns the parameter count, the seconds (host clock, synchronised),
    steps/s, the last logs and the peak device memory in bytes (None on
    the CPU). Seeded weights (torch seed 0) and batch (seed 0); step i's
    draws from a host generator seeded by i. `vae_cfg` (a
    `config.VAEModelConfig`, default the `vae` preset's), `res`,
    `lod_resolutions` and `n_points` cut the model and the scene."""
    dev = resolve_device(device)
    vae_cfg = vae_cfg or preset("vae").vae
    if bf16:
        vae_cfg = dataclasses.replace(vae_cfg, compute_dtype="bfloat16")
    log(f"compute_dtype: {vae_cfg.compute_dtype}")
    torch.manual_seed(0)
    with torch.device(dev):
        model = PointVAE.from_config(vae_cfg, with_encoder=True)
    model.train()
    batch = make_batch(seed=0, batch=1, n_views_in=4, n_views_sup=views,
                       res=res, n_pts=n_points, n_splats=n_points,
                       device=dev)
    batch.pop("gt_gaussians", None)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"params: {n_params / 1e6:.1f}M  device: {dev}")
    loss_cfg = VAELossConfig(lod_resolutions=tuple(lod_resolutions),
                             rand_coarse_lod=True)
    step = make_train_step(model, loss_cfg,
                           TrainStateConfig(lr=1e-4, warmup_steps=10))
    state = TrainState.create(model)
    if dev.type == "cuda":
        from gaussiananything_tpu_torch.ops import rasterize_cuda
        rasterize_cuda.build()          # no step's seconds include nvcc
        torch.cuda.reset_peak_memory_stats(dev)

    def run(i):
        return step(state, batch, generator=torch.Generator().manual_seed(i))

    _sync(dev)
    t0 = time.perf_counter()
    logs = {k: float(v) for k, v in run(0).items()}     # waits for the card
    first = time.perf_counter() - t0
    log(f"first step: {first:.2f}s loss={logs['total']:.4f}")
    out = {"compute_dtype": vae_cfg.compute_dtype, "views": views,
           "params": n_params, "first_step_s": first}
    if steps:
        t0 = time.perf_counter()
        for i in range(steps):
            lg = run(1 + i)
        logs = {k: float(v) for k, v in lg.items()}
        dt = (time.perf_counter() - t0) / steps
        out.update(steady_step_s=dt, steps_per_s=1.0 / dt)
        log(f"steady step: {dt * 1e3:.0f} ms ({1 / dt:.2f} steps/s), "
            f"loss={logs['total']:.4f}")
    out["logs"] = logs
    out["steps_taken"] = state.step
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    if out["peak_bytes"] is not None:
        log(f"peak device memory: {out['peak_bytes'] / 2 ** 30:.2f} GiB")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from gaussiananything_tpu_torch.tools.rasterizer_timing import card_line
    out = feasibility(a.views, a.steps, a.bf16, a.device,
                      log=lambda s: print(s, flush=True))
    out["card"] = card_line(resolve_device(a.device))
    print(TAG + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
