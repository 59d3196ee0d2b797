"""The compositors' work, counted from what a call received: the steps
come from the frozen reference (`reference/raster.composite`), which walks
the depth-ordered tile lists of these gaussians in these views up to each
pixel's termination, so the count does not move when the program's
binning, cull or walk does.

Operations per (pixel, step): the arithmetic of one splat at one pixel in
`composite_chunk`, compares and selects not counted:

    ray-plane p (3 × 2 mul, 2 add)        12    u, v (1 div, 2 mul)      3
    rho3d 3, dx dy 2, rho2d 4, min 1      10    depth (2 mul, 2 add)      4
    gaussian and window (mul, exp, sub,          alpha (mul, min)         2
      mul, 2 clamp, mul)                   7    transmittance (sub, mul,
    blend sums, 7 features (mul, add)     14      2 mul, mul)             5
    expected and median depth              4    distortion terms          9

K2b, the backward, adds the adjoint of each blended step (`chunk_backward`:
the reverse walk's transmittance, the seven feature adjoints, the alpha,
rho, u, v and p adjoints and their accumulation into the 22 splat fields).
"""
from __future__ import annotations

import torch

from benchmark.counts import peaks

OPS_FWD = 70            # per (pixel, step), the list above
OPS_BWD = 139           # per (pixel, blended step), K2b's adjoints
SPLAT_BYTES = 13 * 4    # a 13-channel fp32 gaussian
CAMERA_BYTES = 2 * 16 * 4
OUT_CHANNELS = 10       # the composite buffer


def forward_view(steps: torch.Tensor, n_splats: int, size: int, tile: int
                 ) -> dict:
    """One forward view: operations, bytes, the bound seconds and which
    of the two bounds it is."""
    ops = int(steps.sum()) * tile * tile * OPS_FWD
    nbytes = n_splats * SPLAT_BYTES + CAMERA_BYTES \
        + OUT_CHANNELS * size * size * 4
    return bound(ops, nbytes)


def bound(ops: int, nbytes: int) -> dict:
    t_ops, t_bytes = ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def backward_view(steps: torch.Tensor, blended: torch.Tensor,
                  n_splats: int, size: int, tile: int) -> dict:
    """One backward view: the forward arithmetic of every step again (the
    reverse walk needs each pixel's transmittance) and the adjoints of the
    blended pairs; bytes: the gaussians, the cameras and the maps'
    cotangent read, the gaussians' gradient written."""
    ops = int(steps.sum()) * tile * tile * OPS_FWD \
        + int(blended.sum()) * OPS_BWD
    nbytes = 2 * n_splats * SPLAT_BYTES + CAMERA_BYTES \
        + OUT_CHANNELS * size * size * 4
    return bound(ops, nbytes)


def mean_view(views) -> dict:
    """The mean of views' counts: a launch's bound where the launch is
    known by its LoD alone."""
    n = len(views)
    ops = sum(v["ops"] for v in views) / n
    nbytes = sum(v["bytes"] for v in views) / n
    return bound(ops, nbytes)
