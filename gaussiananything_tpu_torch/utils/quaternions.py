"""Quaternion utilities (port of `gaussiananything_tpu/utils/quaternions.py`).

Quaternions are (w, x, y, z), matching the reference convention.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-8, dim: int = -1
              ) -> torch.Tensor:
    """Safe normalise: v · rsqrt(Σv² + eps²).

    NOT `v / (‖v‖ + eps)`: sqrt has infinite slope at 0, so that form emits
    NaN gradients for exactly-zero vectors (e.g. padded dummy splats).
    """
    return v * torch.rsqrt((v * v).sum(dim, keepdim=True) + eps * eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix whose columns
    are the rotated basis axes (column 2 = surfel normal)."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))
