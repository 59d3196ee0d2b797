"""Point-cloud losses (port of `gaussiananything_tpu/ops/pointcloud.py`):
the chamfer distance, standing in for pytorch3d's
(`nsr/train_nv_util.py:2244`), and a Sinkhorn EMD, standing in for the
reference's auction EMD (`utils/emd/emd_module.py`)."""
from __future__ import annotations

import math
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


def sinkhorn_emd(a: torch.Tensor, b: torch.Tensor, eps: float = 0.05,
                 iters: int = 200) -> torch.Tensor:
    """Entropic-regularised EMD between point sets a (..., N, 3) and
    b (..., M, 3) with uniform marginals 1/N and 1/M: `iters` log-domain
    Sinkhorn updates of the potentials f, g, then Σ P·C with
    P = exp((f + g − C) / eps). One value per batch element."""
    batch = a.shape[:-2]
    af = a.reshape((-1,) + a.shape[-2:]).float()
    bf = b.reshape((-1,) + b.shape[-2:]).float()
    C = _sq_dists(af, bf)                                   # (B, n, m)
    n, m = C.shape[1], C.shape[2]
    log_mu, log_nu = -math.log(n), -math.log(m)
    f = C.new_zeros(C.shape[:2])
    g = C.new_zeros((C.shape[0], m))
    for _ in range(iters):
        f = eps * (log_mu - torch.logsumexp((g[:, None, :] - C) / eps, 2))
        g = eps * (log_nu - torch.logsumexp((f[:, :, None] - C) / eps, 1))
    P = torch.exp((f[:, :, None] + g[:, None, :] - C) / eps)
    return (P * C).sum((1, 2)).reshape(batch)
