"""Rasterizer frame timing: phase split, forward frame of every entry point,
forward + backward of the training route (port of
`tools/rasterizer_timing.py`).

    python -m gaussiananything_tpu_torch.tools.rasterizer_timing \\
        [--res 512] [--iters 20] [--splats 73728] [--tile 16] [--mpt 2048] \\
        [--chunk 256] [--group 16] \\
        [--impl cuda|cuda_dma|v1|v1_aux|v2|v3|plain] [--all] [--device cuda]

It times, on the bench scene (a 73,728-splat sphere seen from (20°, 45°)):

  * the phases preprocess, binning (`build_tile_pairs`) and composite only
    (the compositor on a prebuilt table and pair lists);
  * the forward frame of `--impl` with its rays/s and a value digest (the
    sum of the image's first 4,096 values: a frame that did not run, or ran
    on garbage, shows there);
  * for `cuda`, forward + backward through the training kernels.

`--impl`: "cuda" is `rasterize_tiled` (K1; K2a + K2b in the backward),
"cuda_dma" `rasterize_tiled_v4_dma` (K6), "v1" / "v1_aux"
`rasterize_tiled_v1` (K3 without and with the distortion), "v2"
`rasterize_tiled_v2` (K4), "v3" `rasterize_tiled_v3` (K5), "plain" the
plain PyTorch compositor. `--all` runs every one and ends with the A/B of
the two v4 feeds: K1 reading splat rows through the pair indices against
K6 reading the segment-ordered table, with what the table's gather costs.

Every timed function runs once to warm up and then `--iters` times. On the
card the times are CUDA-event times of the whole run over `--iters`; with
`--device cpu` (small shapes only) they are host-clock times and say
nothing about the card.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.ops import rasterize_cuda
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.utils.device import resolve_device

IMPLS = ("cuda", "cuda_dma", "v1", "v1_aux", "v2", "v3", "plain")


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them, or the
    word "cpu": what every time printed here was taken on."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[dev.index or 0] if smi.returncode == 0 and lines \
        else torch.cuda.get_device_name(dev)


def make_timer(dev: torch.device, iters: int, log: Callable[[str], None]):
    """Returns timed(name, fn) -> (milliseconds per call, last result): one
    warm-up call, then `iters` calls between two CUDA events (host clock on
    the CPU), and the digest of the result printed beside the time."""

    def timed(name, fn):
        out = fn()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            ms = (time.perf_counter() - t0) / iters * 1e3
        leaf = out
        while isinstance(leaf, (tuple, list, dict)):
            leaf = next(iter(leaf.values() if isinstance(leaf, dict)
                             else leaf))
        digest = float(leaf.detach().flatten()[:4096].float().sum())
        log(f"{name:>34}: {ms:9.3f} ms   [digest {digest:.6g}]")
        return ms, out

    return timed


def main(argv: Optional[Sequence[str]] = None,
         log: Callable[[str], None] = print) -> Dict[str, float]:
    """Runs the tool; returns {row name: milliseconds} of what it timed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--splats", type=int, default=73728)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--mpt", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--group", type=int, default=16)
    ap.add_argument("--impl", choices=IMPLS, default="cuda")
    ap.add_argument("--all", action="store_true",
                    help="every impl, then the A/B of the two v4 feeds")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    res, tile, mpt, chunk = a.res, a.tile, a.mpt, a.chunk
    frame = dict(tile=tile, max_per_tile=mpt, chunk=chunk)

    g = make_object(0, n=a.splats, kind="sphere", device=dev)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=dev)
    cv, cvp = cam["cam_view"], cam["cam_view_proj"]
    bg = torch.ones(3, device=dev)
    log(f"device={card_line(dev)} res={res} N={a.splats} tile={tile} "
        f"mpt={mpt} chunk={chunk} group={a.group} iters={a.iters}")
    timed = make_timer(dev, a.iters, log)
    rows: Dict[str, float] = {}

    # -- phases -------------------------------------------------------------
    rows["preprocess"], sp = timed(
        "preprocess", lambda: rz.preprocess_splats(g, cv, cvp, res, res))
    rows["binning"], (pairs, starts, counts) = timed(
        "binning (build_tile_pairs)",
        lambda: rz.build_tile_pairs(sp, res, res, tile, mpt))
    tab = rz.splat_table(sp, res, res).contiguous()
    if tile == 16:      # the v4 kernels run 16x16 tiles only
        rows["composite only"], _ = timed(
            "composite only", lambda: rasterize_cuda.composite(
                tab, pairs, starts, counts, bg, res, res, tile=tile,
                chunk=chunk))

    # -- forward frames -----------------------------------------------------
    renders = {
        "cuda": lambda: rz.rasterize_tiled(g, cv, cvp, bg, res, res, **frame),
        "cuda_dma": lambda: rz.rasterize_tiled_v4_dma(g, cv, cvp, bg, res,
                                                      res, **frame),
        "v1": lambda: rz.rasterize_tiled_v1(g, cv, cvp, bg, res, res,
                                            **frame),
        "v1_aux": lambda: rz.rasterize_tiled_v1(g, cv, cvp, bg, res, res,
                                                with_aux=True, **frame),
        "v2": lambda: rz.rasterize_tiled_v2(g, cv, cvp, bg, res, res,
                                            group=a.group, **frame),
        "v3": lambda: rz.rasterize_tiled_v3(g, cv, cvp, bg, res, res,
                                            group=a.group, **frame),
        "plain": lambda: rz.rasterize_tiled(g, cv, cvp, bg, res, res,
                                            impl="plain", **frame),
    }
    for impl in (IMPLS if a.all else (a.impl,)):
        if tile != 16 and impl in ("cuda", "cuda_dma", "plain"):
            log(f"({impl} skipped: the v4 route runs 16x16 tiles)")
            continue
        with torch.no_grad():
            ms, out = timed(f"forward frame [{impl}]", renders[impl])
        rows[f"forward frame [{impl}]"] = ms
        log(f"{'forward rays/s':>34}: {res * res / ms / 1e3:9.2f} M")
        if not bool(torch.isfinite(out["image"]).all()):
            raise RuntimeError(f"the {impl} frame is not finite")

    # -- forward + backward: the training kernels ---------------------------
    if (a.all or a.impl == "cuda") and tile == 16:
        # K2a and K2b stage at most 128 rows a chunk
        bwd_chunk = min(chunk, rasterize_cuda.MAX_CHUNK["bwd"])

        def grad():
            gg = g.clone().requires_grad_(True)
            o = rz.rasterize_tiled(gg, cv, cvp, bg, res, res, tile=tile,
                                   max_per_tile=mpt, chunk=bwd_chunk)
            (o["image"].sum() + o["alpha"].sum() + o["dist"].sum()
             + o["normal_view"].sum() + o["depth_expected"].sum()).backward()
            return gg.grad
        name = f"forward+backward [cuda, chunk {bwd_chunk}]"
        ms, gout = timed(name, grad)
        rows["forward+backward [cuda]"] = ms
        if not bool(torch.isfinite(gout).all()):
            raise RuntimeError("the gradient is not finite")
        fwd = rows["forward frame [cuda]"]
        log(f"{'bwd/fwd ratio':>34}: {max(ms - fwd, 0.0) / fwd:9.2f}x")

    # -- the two v4 feeds ---------------------------------------------------
    if a.all and tile == 16:
        rows["segment gather"], seg = timed(
            "segment table gather", lambda: rz.segment_table(tab, pairs))
        rows["composite only [segments]"], _ = timed(
            "composite only [segments]",
            lambda: rasterize_cuda.composite_segments(
                seg, starts, counts, bg, res, res, tile=tile, chunk=chunk))
        log(f"tab (pair indices) vs segment table, chunk={chunk}: composite "
            f"only {rows['composite only']:.3f} vs "
            f"{rows['composite only [segments]']:.3f} ms + gather "
            f"{rows['segment gather']:.3f} ms; frame "
            f"{rows['forward frame [cuda]']:.3f} vs "
            f"{rows['forward frame [cuda_dma]']:.3f} ms "
            f"({res * res / rows['forward frame [cuda]'] / 1e3:.1f} vs "
            f"{res * res / rows['forward frame [cuda_dma]'] / 1e3:.1f} M "
            f"rays/s)")
    return rows


if __name__ == "__main__":
    main()
