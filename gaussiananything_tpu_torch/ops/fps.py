"""Farthest point sampling (port of `gaussiananything_tpu/ops/fps.py`).

Picks the K latent anchors from the surface point cloud
(`nsr/srt/encoder.py:533`): a K-step loop of a distance update and an
argmax over the N points, batched over the leading dimensions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim with ties to the LOWEST index, as
    `jnp.argmax` promises and `torch.argmax` on CUDA does not."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    is_max = x == x.amax(dim=-1, keepdim=True)
    return torch.where(is_max, idx, torch.full_like(idx, n)).amin(dim=-1)


@torch.no_grad()
def _fps_indices(pts: torch.Tensor, k: int, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    B, n, _ = pts.shape
    big = 1e10
    if valid is None:
        valid = torch.ones((B, n), dtype=torch.bool, device=pts.device)
    last = _first_argmax(valid.to(torch.uint8))             # first valid
    dists = torch.full((B, n), big, dtype=pts.dtype, device=pts.device)
    rows = torch.arange(B, device=pts.device)
    idxs = []
    for _ in range(k):
        idxs.append(last)
        d = ((pts - pts[rows, last][:, None, :]) ** 2).sum(-1)
        dists = torch.minimum(dists, d)
        last = _first_argmax(torch.where(valid, dists,
                                         torch.full_like(dists, -big)))
    return torch.stack(idxs, dim=1)


def sample_farthest_points(points: torch.Tensor, k: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (..., N, 3) → (selected (..., k, 3), indices (..., k)).

    `mask` (..., N) marks the valid input points. The start is the first
    valid point (pytorch3d's `random_start=False`). The indices carry no
    gradient; the selected points are a gather of `points`.
    """
    batch = points.shape[:-2]
    flat = points.reshape((-1,) + points.shape[-2:])
    mflat = None if mask is None else mask.reshape(-1, mask.shape[-1])
    idx = _fps_indices(flat.detach().float(), k, mflat)
    sel = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 3))
    return sel.reshape(batch + (k, 3)), idx.reshape(batch + (k,))
