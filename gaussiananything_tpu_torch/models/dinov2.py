"""DINOv2 ViT with registers, the release image conditioner's backbone
(port of `gaussiananything_tpu/models/dinov2.py`).

The reference conditions on torch-hub `dinov2_vitl14_reg` at 518 px
(`sgm/modules/encoders/modules.py:791-933`). Parameter names are torch-hub's:
cls_token, pos_embed, register_tokens, patch_embed.proj, blocks.{i}.{norm1,
attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}, norm.
`dtype` is the compute dtype (`models/layers.py`): the image, the learned
tokens and the position table enter the blocks cast to it, as the JAX
`Dinov2ViT`'s.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.layers import (Attention, Conv2d,
                                                      LayerNorm, Mlp,
                                                      exact_gelu)
from gaussiananything_tpu_torch.utils.image import resize


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, dtype=dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=exact_gelu,
                       dtype=dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(3, width, patch, stride=patch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def interpolate_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """(1, 1+N0, D) pos-embed → (1, 1+grid², D): the patch grid resized
    bicubically with `jax.image.resize` semantics (`dinov2.py:84-97`), the
    cls position passed through. The identity at the native grid."""
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    g0 = int(round(patch_pos.shape[1] ** 0.5))
    if g0 * g0 != patch_pos.shape[1]:
        raise ValueError(f"pos embed grid {patch_pos.shape[1]} is not square")
    if g0 == grid:
        return pos
    D = pos.shape[-1]
    p = patch_pos.reshape(g0, g0, D).permute(2, 0, 1)      # (D, g0, g0)
    p = resize(p, (grid, grid), "cubic").permute(1, 2, 0)
    return torch.cat([cls_pos, p.reshape(1, grid * grid, D)], dim=1)


class Dinov2ViT(nn.Module):
    """Returns (x_norm_patchtokens, x_norm_clstoken) of the torch model."""

    def __init__(self, patch: int = 14, width: int = 1024, depth: int = 24,
                 heads: int = 16, num_registers: int = 4,
                 img_size: int = 518, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.width = width
        self.num_registers = num_registers
        n0 = (img_size // patch) ** 2
        self.patch_embed = PatchEmbed(patch, width, dtype=dtype)
        self.cls_token = nn.Parameter(torch.randn(1, 1, width) * 1e-6)
        self.pos_embed = nn.Parameter(torch.randn(1, 1 + n0, width) * 0.02)
        self.register_tokens = nn.Parameter(
            torch.randn(1, num_registers, width) * 1e-6)
        self.blocks = nn.ModuleList([Block(width, heads, dtype=dtype)
                                     for _ in range(depth)])
        self.norm = LayerNorm(width, eps=1e-6)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, 3, H, W), imagenet-normalised."""
        B, _, H, W = images.shape
        if H % self.patch or W % self.patch:
            raise ValueError(f"image {H}x{W} is not a multiple of the patch "
                             f"{self.patch}")
        x = self.patch_embed(images)                        # (B, D, g, g)
        grid = x.shape[-1]
        x = x.flatten(2).transpose(1, 2)                    # (B, g², D)
        x = torch.cat([self.cls_token.expand(B, -1, -1).to(x.dtype), x],
                      dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, grid).to(x.dtype)
        # registers go in AFTER the pos add: they carry no position
        x = torch.cat([x[:, :1],
                       self.register_tokens.expand(B, -1, -1).to(x.dtype),
                       x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1 + self.num_registers:], x[:, 0]
