"""Point-cloud losses (port of `chamfer_distance` of
`gaussiananything_tpu/ops/pointcloud.py`; stands in for pytorch3d's,
`nsr/train_nv_util.py:2244`)."""
from __future__ import annotations

from typing import Optional

import torch


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,N,3), (B,M,3) → (B,N,M) squared distances by the product
    expansion."""
    an = (a * a).sum(-1)
    bn = (b * b).sum(-1)
    ab = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp(an[:, :, None] + bn[:, None, :] - 2 * ab, min=0.0)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor,
                     a_mask: Optional[torch.Tensor] = None,
                     b_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric squared chamfer distance, batched over the leading dims:
    a (..., N, 3), b (..., M, 3) → one value per batch element, the sum of
    both directions' means (pytorch3d's point reduction "mean")."""
    batch = a.shape[:-2]
    af = a.reshape((-1,) + a.shape[-2:]).float()
    bf = b.reshape((-1,) + b.shape[-2:]).float()
    d = _sq_dists(af, bf)
    big = 1e10
    xm = None if a_mask is None else a_mask.reshape(-1, a.shape[-2])
    ym = None if b_mask is None else b_mask.reshape(-1, b.shape[-2])
    if xm is not None:
        d = torch.where(xm[:, :, None], d, torch.full_like(d, big))
    if ym is not None:
        d = torch.where(ym[:, None, :], d, torch.full_like(d, big))

    def _mean(v, m):
        if m is None:
            return v.mean(-1)
        return (v * m).sum(-1) / torch.clamp(m.sum(-1), min=1)

    out = _mean(d.amin(dim=2), xm) + _mean(d.amin(dim=1), ym)
    return out.reshape(batch)
