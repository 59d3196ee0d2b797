"""Separable image resize with `jax.image.resize` semantics.

`torch.nn.functional.interpolate(mode="bicubic")` is not the same function:
it uses the cubic kernel with a = −0.75 and clamps at the borders, while
the JAX package resizes (`data/synthetic.py:100`, `models/conditioner.py:141`,
`models/dinov2.py:96`) with Keys' kernel a = −0.5 at half-pixel centres,
renormalises the weights at the borders and, when downsampling, widens the
kernel (antialias). This module builds those resize matrices itself and
applies them in IEEE fp32 (`jax.image.resize`'s default precision is
`Precision.HIGHEST`), and writes PNGs with the standard library alone.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from gaussiananything_tpu_torch.utils.precision import highest_einsum


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_matrix(n_in: int, n_out: int, method: str = "cubic",
                  antialias: bool = True, device="cpu") -> torch.Tensor:
    """(n_in, n_out) weights: out[j] = Σ_i in[i] · W[i, j]."""
    kernel = _KERNELS[method]
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                          device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size, method: str = "cubic",
           antialias: bool = True) -> torch.Tensor:
    """Resize the last two dims of x (..., H, W) to size = (h, w)."""
    h, w = size
    H, W = x.shape[-2:]
    x = x.float()
    if H != h:
        x = highest_einsum("...hw,hH->...Hw", x,
                           resize_matrix(H, h, method, antialias, x.device))
    if W != w:
        x = highest_einsum("...hw,wW->...hW", x,
                           resize_matrix(W, w, method, antialias, x.device))
    return x


def save_png(path: str, rgb: np.ndarray):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (stdlib zlib)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)   # filter 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
