"""Release-batch flow-matching training on one card (port of
`tools/fm_feasibility.py`).

    python -m gaussiananything_tpu_torch.tools.fm_feasibility \\
        [--batch 256] [--accum 8] [--stage 1|2] [--steps 5] [--train-cond]
    python -m gaussiananything_tpu_torch.tools.fm_feasibility \\
        --probe-micro [8 16 32 64 128 256]

DiT-L (24 × 1024 over 768 point tokens, per-block recomputation `remat`)
against a ViT-L image conditioner (24 × 1024 at 224², frozen, or trained
at 0.5× the learning rate with `--train-cond`), at the release recipe's
GLOBAL batch 256 through gradient accumulation
(`shell_scripts/release/train/stage-2-diffusion/i23d-pcd-gen.sh`; the
reference's micro-batch loop, `nsr/lsgm/flow_matching_trainer.py:491-572`),
on seeded numpy inputs through `train/fm_trainer.make_fm_train_step`.
Prints the parameter counts, the first step's seconds, the steady step's
seconds and samples/s, and the peak device memory
(`torch.cuda.max_memory_allocated`), then one JSON line of them with the
card's name and power limit.

`--probe-micro M...` runs one step for each micro-batch size m in
ascending order, each in a fresh process, until one runs out of memory:
a batch of 2m as two micro-batches, so the peak holds an accumulated
gradient beside one micro-batch's activations, as every step of the
release batch does. It prints the largest m that fits.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gaussiananything_tpu_torch.diffusion.transport import create_transport
from gaussiananything_tpu_torch.models.conditioner import ImageConditioner
from gaussiananything_tpu_torch.models.dit import stage1_dit, stage2_dit
from gaussiananything_tpu_torch.train.fm_trainer import (FMConfig,
                                                         make_fm_train_step)
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    TrainStateConfig)
from gaussiananything_tpu_torch.utils.device import resolve_device

N_POINTS = 768
DIT_KW = dict(cond_dim=1024, vector_dim=1024)           # DiT-L
COND_KW = dict(width=1024, depth=24, heads=16, img_size=224, ucg_rate=0.1,
               backbone="scratch")                       # ViT-L
PROBE_MICRO = (8, 16, 32, 64, 128, 256)
TAG = "FM-FEASIBILITY "
MODULE = "gaussiananything_tpu_torch.tools.fm_feasibility"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def feasibility(batch: int = 256, accum: int = 8, stage: int = 1,
                steps: int = 5, train_cond: bool = False, device="cuda",
                dit_size: str = "L", dit_kw: Optional[dict] = None,
                cond_kw: Optional[dict] = None, n_points: int = N_POINTS,
                log: Callable[[str], None] = print) -> dict:
    """One first step and `steps` steady steps of the flow-matching step
    at `batch` in `accum` micro-batches; returns the parameter counts,
    the seconds (host clock, synchronised), samples/s, the last logs and
    the peak device memory in bytes (None on the CPU). Seeded weights
    (torch seed 0) and inputs (numpy seed 0); each step's draws from a
    host generator seeded by its index."""
    dev = resolve_device(device)
    torch.manual_seed(0)
    in_ch = 3 if stage == 1 else 10
    mk = stage1_dit if stage == 1 else stage2_dit
    with torch.device(dev):
        dit = mk(dit_size, remat=True, **(DIT_KW if dit_kw is None
                                          else dit_kw))
        cond = ImageConditioner(**(COND_KW if cond_kw is None else cond_kw))
    dit.train()
    cond.train()
    rng = np.random.default_rng(0)
    img = cond.img_size
    arrays = {"cond": rng.uniform(size=(batch, 3, img, img)),
              "latent": rng.normal(size=(batch, n_points, in_ch))}
    if stage == 2:
        arrays["xyz"] = rng.normal(size=(batch, n_points, 3))
    data = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in arrays.items()}
    step = make_fm_train_step(dit, cond, create_transport("gvp"),
                              FMConfig(stage=stage),
                              TrainStateConfig(lr=1e-4, warmup_steps=10),
                              accum=accum)
    state = TrainState.create(dit)
    cstate = TrainState.create(cond, frozen=not train_cond)
    n_dit = sum(p.numel() for p in dit.parameters())
    n_cond = sum(p.numel() for p in cond.parameters())
    log(f"DiT params: {n_dit / 1e6:.1f}M  cond params: {n_cond / 1e6:.1f}M "
        f"(trained: {train_cond})  batch {batch} = {accum} x "
        f"{batch // accum}; device {dev}")

    def run(i):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logs = step(state, cstate, data,
                    generator=torch.Generator().manual_seed(i))
        logs = {k: float(v) for k, v in logs.items()}   # waits for the card
        return logs, time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    logs, first = run(0)
    log(f"first step: {first:.3f}s fm_loss={logs['fm_loss']:.4f}")
    out = {"batch": batch, "accum": accum, "micro": batch // accum,
           "stage": stage, "train_cond": train_cond,
           "dit_params": n_dit, "cond_params": n_cond,
           "first_step_s": first}
    if steps:
        times = []
        for i in range(steps):
            logs, dt = run(1 + i)
            times.append(dt)
        steady = float(np.median(times))
        out.update(steady_step_s=steady, step_s=times,
                   samples_per_s=batch / steady)
        log(f"steady step: {steady * 1e3:.0f} ms (median of {steps}; "
            f"{batch / steady:.1f} samples/s), fm_loss="
            f"{logs['fm_loss']:.4f}")
    out["logs"] = logs
    out["steps_taken"] = state.step
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    if out["peak_bytes"] is not None:
        log(f"peak device memory: {out['peak_bytes'] / 2 ** 30:.2f} GiB")
    return out


def probe_micro(sizes: Sequence[int], stage: int, train_cond: bool,
                log: Callable[[str], None] = print) -> dict:
    """One step at batch 2m in two micro-batches for each m of `sizes`,
    ascending, each in a fresh process, until one runs out of memory;
    returns each size's result and the largest m that fit."""
    runs, largest = [], None
    for m in sorted(sizes):
        cmd = [sys.executable, "-m", MODULE, "--batch", str(2 * m),
               "--accum", "2", "--steps", "0", "--stage", str(stage)]
        if train_cond:
            cmd.append("--train-cond")
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800, cwd=ROOT)
        lines = [ln[len(TAG):] for ln in res.stdout.splitlines()
                 if ln.startswith(TAG)]
        if res.returncode != 0 or not lines:
            raise RuntimeError(f"micro-batch {m}: the step failed "
                               f"(exit {res.returncode}):\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        rec = json.loads(lines[-1])
        rec["micro"] = m
        runs.append(rec)
        peak = rec.get("peak_bytes")
        log(f"micro-batch {m}: "
            + ("out of memory" if rec["oom"] else
               f"{rec['first_step_s']:.2f}s for batch {2 * m}, peak "
               f"{peak / 2 ** 30:.2f} GiB"))
        if rec["oom"]:
            break
        largest = m
    return {"runs": runs, "largest_micro": largest}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--stage", type=int, default=1, choices=[1, 2])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--train-cond", action="store_true")
    ap.add_argument("--probe-micro", type=int, nargs="*", default=None,
                    metavar="M", help="probe these micro-batch sizes "
                    f"(none given: {' '.join(map(str, PROBE_MICRO))})")
    a = ap.parse_args(argv)
    from gaussiananything_tpu_torch.tools.rasterizer_timing import card_line
    dev = resolve_device("cuda")
    if a.probe_micro is not None:
        out = probe_micro(a.probe_micro or PROBE_MICRO, a.stage,
                          a.train_cond, log=lambda s: print(s, flush=True))
        print(f"largest micro-batch that fits: {out['largest_micro']}",
              flush=True)
    else:
        try:
            out = feasibility(a.batch, a.accum, a.stage, a.steps,
                              a.train_cond, dev,
                              log=lambda s: print(s, flush=True))
            out["oom"] = False
        except torch.OutOfMemoryError:      # the answer a probe is after
            out = {"oom": True, "batch": a.batch, "accum": a.accum,
                   "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    out["card"] = card_line(dev)
    print(TAG + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
