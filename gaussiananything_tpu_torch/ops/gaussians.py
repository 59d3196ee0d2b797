"""13-channel 2D surfel layout (port of `gaussiananything_tpu/ops/gaussians.py`).

Channel layout (parity with `nsr/gs_surfel.py:67-72`):
    [0:3] xyz, [3:4] opacity, [4:6] scale, [6:10] rotation (w, x, y, z),
    [10:13] rgb.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

POS_BOUND = 0.45
# offsets: tanh · 0.45 · 0.5 · skip_weight 0.1 (`vit/vit_triplane.py:1289`)
POS_OFFSET_GAIN = 0.45 * 0.5 * 0.1
SCALE_GAIN = 0.45 * 0.01 / float(np.log(2.0))  # softplus(0) = ln 2


class GaussianSplats(NamedTuple):
    xyz: torch.Tensor        # (..., N, 3)
    opacity: torch.Tensor    # (..., N, 1)
    scale: torch.Tensor      # (..., N, 2)
    rotation: torch.Tensor   # (..., N, 4)
    rgb: torch.Tensor        # (..., N, 3)


def unpack_gaussians(g: torch.Tensor) -> GaussianSplats:
    if g.shape[-1] != 13:
        raise ValueError(f"expected 13 channels, got {g.shape[-1]}")
    return GaussianSplats(xyz=g[..., 0:3], opacity=g[..., 3:4],
                          scale=g[..., 4:6], rotation=g[..., 6:10],
                          rgb=g[..., 10:13])


def pack_gaussians(s: GaussianSplats) -> torch.Tensor:
    return torch.cat([s.xyz, s.opacity, s.scale, s.rotation, s.rgb], dim=-1)


def activate_gaussians(raw: torch.Tensor, anchor_xyz: torch.Tensor,
                       skip_weight: float = 0.1,
                       pos_bound: float = POS_BOUND) -> torch.Tensor:
    """raw 13-channel head output + anchor positions → activated gaussians:
    pos = clip(anchor + tanh(raw)·pos_bound·0.5·skip_weight, ±pos_bound)
    (`vit/vit_triplane.py:1289,1303-1313`), the rest as
    `activate_gaussians_at`. Always fp32."""
    offset = torch.tanh(raw[..., 0:3].float()) \
        * (pos_bound * 0.5 * skip_weight)
    xyz = torch.clamp(anchor_xyz.float() + offset, -pos_bound, pos_bound)
    return activate_gaussians_at(xyz, raw)


def activate_gaussians_at(pos: torch.Tensor, raw: torch.Tensor
                          ) -> torch.Tensor:
    """Activate opacity/scale/rot/rgb from `raw` with the position given
    directly (`vit/vit_triplane.py:1425-1436`). Always fp32."""
    raw = raw.float()
    opacity = torch.sigmoid(raw[..., 3:4])
    scale = F.softplus(raw[..., 4:6]) * SCALE_GAIN
    rot = raw[..., 6:10]
    rot = rot * torch.rsqrt((rot * rot).sum(-1, keepdim=True) + 1e-16)
    rgb = 0.5 * torch.tanh(raw[..., 10:13]) + 0.5
    return torch.cat([pos.float(), opacity, scale, rot, rgb], dim=-1)


def inverse_sigmoid(x, eps: float = 1e-6) -> torch.Tensor:
    x = torch.clamp(torch.as_tensor(x), eps, 1 - eps)
    return torch.log(x) - torch.log1p(-x)
