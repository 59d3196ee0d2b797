"""DiT2, the VAE decoder's backbone (port of
`gaussiananything_tpu/models/dit2_decoder.py`).

The input sequence starts as a learned query table (`pos_embed`, 1×K×D);
each projected latent token modulates its own query token through a
per-token adaLN (`dit/dit_decoder.py:15-35`). Release semantics
(`dit/dit_decoder.py:103-160`, roll_out, plane_n = 3, in-plane attention):
EVEN blocks attend within each of the 3 contiguous K/3-token groups, ODD
blocks globally; attention is qk-normed, MLPs use exact GELU, and no norm
follows the last block. Without `release_parity` every block attends
globally, without qk-norm and with the tanh GELU, and a LayerNorm (`norm`)
follows the last block. `dtype` is the compute dtype (`models/layers.py`):
the query table enters the blocks cast to it, as the JAX trunk's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.layers import (Attention, LayerNorm,
                                                      Linear, Mlp,
                                                      approx_gelu, exact_gelu,
                                                      modulate)


class DiTBlock2(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 release_parity: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.norm2 = LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.attn = Attention(dim, heads, qk_norm=release_parity,
                              dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim,
                       act=exact_gelu if release_parity else approx_gelu,
                       dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(dim, 6 * dim, dtype=dtype))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x, c: (B, K, D); c is the per-token conditioning."""
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = \
            self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + g_a * self.attn(modulate(self.norm1(x), sh_a, sc_a))
        return x + g_m * self.mlp(modulate(self.norm2(x), sh_m, sc_m))


class DiT2(nn.Module):
    def __init__(self, num_tokens: int = 768, width: int = 768,
                 depth: int = 12, heads: int = 12, plane_n: int = 3,
                 release_parity: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.release_parity = release_parity
        self.dtype = dtype
        if release_parity and num_tokens % plane_n:
            raise ValueError(f"{num_tokens} tokens do not split into "
                             f"{plane_n} planes")
        self.plane_n = plane_n
        self.pos_embed = nn.Parameter(
            torch.randn(1, num_tokens, width) * 0.02)
        self.blocks = nn.ModuleList(
            [DiTBlock2(width, heads, release_parity=release_parity,
                       dtype=dtype) for _ in range(depth)])
        self.norm = None if release_parity else LayerNorm(width, eps=1e-6)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c (B, K, D) projected latent tokens → (B, K, D)."""
        B, K, D = c.shape
        n = self.plane_n
        x = self.pos_embed.expand(B, -1, -1).to(self.dtype)
        for i, blk in enumerate(self.blocks):
            if self.release_parity and i % 2 == 0:
                x = blk(x.reshape(B * n, K // n, D),
                        c.reshape(B * n, K // n, D)).reshape(B, K, D)
            else:
                x = blk(x, c)
        # (the JAX trunk casts the final norm back to the compute dtype)
        return x if self.norm is None else self.norm(x).to(x.dtype)
