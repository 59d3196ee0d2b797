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


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion, w >= 0.

    Branch-free Shepperd's method: all four candidates, the one of the
    largest diagonal combination kept (ties to the lowest, as `jnp.argmax`).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    tx = 1 + m00 - m11 - m22
    ty = 1 - m00 + m11 - m22
    tz = 1 - m00 - m11 + m22
    tw = 1 + m00 + m11 + m22
    q_w = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], -1) \
        / (2 * _sqrt(tw))[..., None]
    q_x = torch.stack([m21 - m12, tx, m01 + m10, m02 + m20], -1) \
        / (2 * _sqrt(tx))[..., None]
    q_y = torch.stack([m02 - m20, m01 + m10, ty, m12 + m21], -1) \
        / (2 * _sqrt(ty))[..., None]
    q_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, tz], -1) \
        / (2 * _sqrt(tz))[..., None]

    t = torch.stack([tw, tx, ty, tz], -1)
    order = torch.arange(4, device=m.device)
    idx = torch.where(t == t.amax(-1, keepdim=True), order,
                      torch.full_like(order, 4)).amin(-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=-2)       # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)
