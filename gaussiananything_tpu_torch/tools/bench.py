"""Benchmark: rays/s of the production forward render at 512² with the
release splat count (port of `bench.py`).

    python -m gaussiananything_tpu_torch.tools.bench [--device cuda]

Renders the bench scene (a 73,728-splat sphere seen from (20°, 45°))
through `render_multiview` (K1 on the card) with `max_per_tile` 2048 and
chunk 128, all map channels computed: one warm-up batch, then `--repeats`
timed batches of `--iters` frames, each batch between two CUDA events (host
clock with `--device cpu`, for small shapes only). Prints ONE JSON line:
the median rays/s as `value`, the spread, the median frame milliseconds,
and the card's name and power limit. It compares with no baseline: the
JAX package's `vs_baseline` divides by an estimate, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Optional, Sequence

import torch

from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.tools.rasterizer_timing import card_line
from gaussiananything_tpu_torch.utils.device import resolve_device

REPEATS = 7          # timed batches (median reported)
ITERS_PER_REPEAT = 20


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--splats", type=int, default=73728)
    ap.add_argument("--mpt", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--iters", type=int, default=ITERS_PER_REPEAT)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    g = make_object(0, n=a.splats, kind="sphere", device=dev)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=dev)
    bg = torch.ones((1, 1, 3), device=dev)

    @torch.no_grad()
    def run_batch():
        """`--iters` frames; returns (seconds per frame, digest)."""
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        digest = 0.0
        for _ in range(a.iters):
            out = render_multiview(
                g[None], cam["cam_view"][None, None],
                cam["cam_view_proj"][None, None], bg, a.res, tile=16,
                max_per_tile=a.mpt, chunk=a.chunk)["image"]
            digest = digest + out.sum()
        if dev.type == "cuda":
            end.record()
            torch.cuda.synchronize(dev)
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        return seconds / a.iters, float(digest)

    _, digest = run_batch()
    if not (math.isfinite(digest) and digest != 0.0):
        raise RuntimeError(f"the bench frames are empty or not finite "
                           f"(digest {digest})")
    times = [run_batch()[0] for _ in range(a.repeats)]
    dt = statistics.median(times)

    def rays(t):
        return a.res * a.res / t

    result = {
        "metric": f"2DGS render rays/s/chip @{a.res}x{a.res}, "
                  f"{a.splats} splats",
        "value": round(rays(dt), 1),
        "unit": "rays/s",
        "repeats": a.repeats,
        "value_min": round(rays(max(times)), 1),
        "value_max": round(rays(min(times)), 1),
        "frame_ms_median": round(dt * 1e3, 4),
        "device": card_line(dev),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
