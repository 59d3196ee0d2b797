"""The grouped (v2) kernel cut off stage by stage (port of
`tools/pallas_bisect.py` and `tools/pallas_bisect2.py`).

    python -m gaussiananything_tpu_torch.tools.kernel_stages [stage ...] \\
        [--layout row|field|both] [--seed N] [--device cuda] \
        [--groups 8] [--group 8] [--pixels 256] [--chunks 4] [--chunk 256]

The JAX tools compile `make_kernel(stage)` for stage 0 (Σρ), 1 (Σα), 2 (Σw
and T) and 3 (rgb, Σw and T) to find which part of the grouped kernel stalls
the compiler, once on row-major inputs (geom (T, M, 16)) and once on
field-major ones (geom (16, T, M)). Their counterparts here are eight
instantiations of one CUDA kernel (`stage_kernel<stage, field_major>` in
`csrc/rasterize_v1.cu`), built together with the other list kernels at
first use; the build's seconds are printed once, then for each stage its
first call's seconds, its steady milliseconds and the digest (the sum of the
output state), as the JAX tools print them.

On the card a tile is a block and a group of `--group` tiles one
thread-block cluster, which tests the group's transmittance once per chunk:
the card schedules clusters of at most 16 blocks, so `--group` is at most
16 there (`rasterize_cuda.stage` refuses a group it cannot schedule as one
cluster at the given pixels and chunk; `--chunk` a multiple of 4 for the
field-major layout).

Inputs: all ones, as in the JAX tools, or with `--seed` random splats (the
inputs the tests and `chip_smoke.py` hold the kernels to `stage_plain`
on). Shape: the JAX tools' 8 groups of 8 tiles of 256 pixels, 4 chunks of 256
rows, unless the options say otherwise (a small shape for `--device cpu`).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussiananything_tpu_torch.ops import kernel_lib, rasterize_cuda
from gaussiananything_tpu_torch.utils.device import resolve_device

# the JAX tools' constants (`tools/pallas_bisect.py:9-11`)
G, P, CHUNK, NC, NG = 8, 256, 256, 4, 8
# the witness's tile 0 ends chunk 1 with T near this, below T_EPS = 1e-4
WITNESS_T = 8e-5


def make_inputs(seed: Optional[int], device, group: int = G, pixels: int = P,
                chunk: int = CHUNK, n_chunks: int = NC, n_groups: int = NG
                ) -> Tuple[torch.Tensor, ...]:
    """Row-major inputs (gmax, geom, feat, px, py) of the stage kernels.

    seed None: all ones, the JAX tools' inputs. Otherwise seeded splats in
    the layout of `pack_tile_inputs`: tile t's pixels are a square at
    column t of a one-row image; each row is a surfel of 1-4 pixels' extent
    near its tile, under a slightly perspective w row, with opacity in
    [0.05, 0.9]; `gmax` draws some groups short of the full chunk count.
    """
    T, M = n_groups * group, n_chunks * chunk
    if seed is None:
        arrays = (np.full((n_groups,), M, np.int32),
                  np.ones((T, M, 16), np.float32),
                  np.ones((T, M, 8), np.float32),
                  np.ones((T, pixels), np.float32),
                  np.ones((T, pixels), np.float32))
        return tuple(torch.from_numpy(x).to(device) for x in arrays)
    rng = np.random.default_rng(seed)
    side = int(round(pixels ** 0.5))
    lidx = np.arange(pixels)
    px = (np.arange(T)[:, None] * side + lidx[None] % side).astype(np.float32)
    py = np.broadcast_to((lidx // side).astype(np.float32), (T, pixels))
    centre = np.stack([(np.arange(T) + 0.5) * side,
                       np.full(T, 0.5 * side)], -1)[:, None, :]
    c = centre + rng.uniform(-0.75 * side, 0.75 * side, (T, M, 2))
    th = rng.uniform(0, np.pi, (T, M))
    su, sv = rng.uniform(1.0, 4.0, (2, T, M))
    w = rng.uniform(-1e-3, 1e-3, (T, M, 2))
    z = rng.uniform(1.0, 3.0, (T, M))
    zero, one = np.zeros((T, M)), np.ones((T, M))
    geom = np.stack([
        su * np.cos(th) + c[..., 0] * w[..., 0],
        -sv * np.sin(th) + c[..., 0] * w[..., 1], c[..., 0],
        su * np.sin(th) + c[..., 1] * w[..., 0],
        sv * np.cos(th) + c[..., 1] * w[..., 1], c[..., 1],
        w[..., 0], w[..., 1], one, zero, zero, z, c[..., 0], c[..., 1], z,
        rng.uniform(0.05, 0.9, (T, M))], -1).astype(np.float32)
    feat = np.concatenate([rng.uniform(0, 1, (T, M, 3)),
                           rng.normal(size=(T, M, 3)), np.ones((T, M, 1)),
                           np.zeros((T, M, 1))], -1).astype(np.float32)
    gmax = rng.integers(1, M + 1, n_groups).astype(np.int32)
    gmax[0] = M
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (gmax, geom, feat, px, py))


def make_witness(seed: int, device, group: int = G, pixels: int = P,
                 chunk: int = CHUNK, n_chunks: int = NC, n_groups: int = NG
                 ) -> Tuple[torch.Tensor, ...]:
    """`make_inputs(seed)` with tile 0 saturating just below T_EPS at the
    end of chunk 1 while its group partner, tile 1, stays live: the scene
    on which a per-tile exit differs from the group test.

    Tile 0's first two chunks are one splat far larger than the tile
    (scale 1000 px, centred on it), opacity `op` with (1 - op)^(2·chunk) =
    WITNESS_T, so every pixel ends chunk 1 near it; its later chunks are
    the seeded splats, which keep shrinking T while the group runs on.
    Tile 1's first two chunks keep their splats at 1/100 of their opacity
    (T stays above 1e-2). Group 0 runs every chunk (gmax = M). Needs
    `group` >= 2 and `n_chunks` >= 3."""
    gmax, geom, feat, px, py = make_inputs(seed, device, group, pixels,
                                           chunk, n_chunks, n_groups)
    geom = geom.clone()
    side = int(round(pixels ** 0.5))
    head = 2 * chunk
    op = 1.0 - WITNESS_T ** (1.0 / head)
    cx, cy, scale = 0.5 * side, 0.5 * side, 1000.0
    row = torch.tensor([scale, 0.0, cx, 0.0, scale, cy, 0.0, 0.0, 1.0, 0.0,
                        0.0, 2.0, cx, cy, 2.0, op], dtype=geom.dtype)
    geom[0, :head] = row.to(geom.device)
    geom[1, :head, 15] *= 0.01
    gmax[0] = geom.shape[1]
    return gmax, geom, feat, px, py


def to_field_major(geom, feat, px, py):
    """Row-major (T, M, F) inputs → the field-major layout (F, T, M) of
    `tools/pallas_bisect2.py`, pixel tables (1, T, P)."""
    return (geom.permute(2, 0, 1).contiguous(),
            feat.permute(2, 0, 1).contiguous(), px[None].contiguous(),
            py[None].contiguous())


def main(argv: Optional[Sequence[str]] = None,
         log: Callable[[str], None] = print) -> Dict[str, float]:
    """Runs the tool; returns {"row stage 0": digest, ...}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--layout", choices=("row", "field", "both"),
                    default="both")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--groups", type=int, default=NG)
    ap.add_argument("--group", type=int, default=G,
                    help="tiles per group: one thread-block cluster on the "
                    "card, so at most 16 there")
    ap.add_argument("--pixels", type=int, default=P)
    ap.add_argument("--chunks", type=int, default=NC)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    gmax, geom, feat, px, py = make_inputs(a.seed, dev, a.group, a.pixels,
                                           a.chunk, a.chunks, a.groups)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        rasterize_cuda.library("v1")
        log(f"build of {kernel_lib.SOURCES['v1'][0]} (all stages, with the "
            f"other sources in parallel): {time.perf_counter() - t0:7.2f} s")
    digests = {}
    for layout in (("row", "field") if a.layout == "both" else (a.layout,)):
        field = layout == "field"
        args = (geom, feat, px, py)
        if field:
            args = to_field_major(*args)
        for stage in a.stages:
            def run():
                out = rasterize_cuda.stage(stage, gmax, *args, a.group,
                                           a.chunk, field_major=field)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return out
            t0 = time.perf_counter()
            out = run()
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(a.iters):
                run()
            ms = (time.perf_counter() - t0) / max(a.iters, 1) * 1e3
            digests[f"{layout} stage {stage}"] = float(out.sum())
            log(f"{layout:>5} stage {stage}: first call {first:7.3f} s, then "
                f"{ms:8.3f} ms a call  digest {float(out.sum()):.3e}")
    return digests


if __name__ == "__main__":
    main()
