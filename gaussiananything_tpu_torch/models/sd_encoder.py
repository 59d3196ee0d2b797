"""Release-parity SD conv encoder trunk (port of
`gaussiananything_tpu/models/sd_encoder.py`).

The reference's `ldm.modules.diffusionmodules.model.Encoder` trunk as the
release configures it (`nsr/script_util.py:1425-1443`: ch=64, ch_mult
(1,2,4,4), 1 res block, attn_type 'mv-vanilla') with the Hybrid encoder's
`conv_out = Identity` surgery (`nsr/srt/encoder.py:487`). Parameter names
are the reference's: `conv_in`, `down.{i}.block.0`, `down.{i}.downsample.
conv`, `mid.block_1`, `mid.attn_1`, `mid.block_2`, `norm_out`.

Tensors are NCHW inside (the JAX package runs NHWC); the public layout is
(B, V, C, H, W) in and out. `dtype` is the compute dtype of the convs and
linear layers (`models/layers.py`); the norms are fp32, and so is the
trunk's output (`norm_out`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaussiananything_tpu_torch.models.layers import (Attention, Conv2d,
                                                      GroupNorm32, LayerNorm,
                                                      Linear, ResBlock,
                                                      exact_gelu)

SDResnetBlock = ResBlock


class SDDownsample(nn.Module):
    """`Downsample`: pad (0,1,0,1), then a VALID 3x3 stride-2 conv."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class GEGLUFeedForward(nn.Module):
    """`FeedForward(glu=True)`: GEGLU projection dim → 2·4·dim, then a
    Linear back (`ldm/modules/attention.py`; names `net.0.proj`, `net.2`)."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = Linear(dim, 2 * dim * mult, dtype=dtype)
        self.net = nn.ModuleList([geglu, nn.Identity(),
                                  Linear(dim * mult, dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * exact_gelu(gate))


class MVMidAttention(nn.Module):
    """`SpatialTransformer3D(in_ch, n_heads=8, d_head=64, depth=1)`
    (`ldm/modules/attention.py:721-780`): attn1 attends jointly over all
    views' tokens, attn2 per view, then a GEGLU feed-forward; a residual
    around the whole module with a zero-initialised `proj_out`. GroupNorm
    statistics are per view. Input and output (B, V, C, h, w)."""

    def __init__(self, ch: int, heads: int = 8, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(ch)
        self.proj_in = Linear(ch, inner, dtype=dtype)
        self.norm1 = LayerNorm(inner, eps=1e-5)
        self.attn1 = Attention(inner, heads, qkv_bias=False, dtype=dtype)
        self.norm2 = LayerNorm(inner, eps=1e-5)
        self.attn2 = Attention(inner, heads, qkv_bias=False, dtype=dtype)
        self.norm3 = LayerNorm(inner, eps=1e-5)
        self.ff = GEGLUFeedForward(inner, dtype=dtype)
        self.proj_out = Linear(inner, ch, dtype=dtype)
        nn.init.zeros_(self.proj_out.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, V, C, hh, ww = x.shape
        h = self.norm(x.reshape(B * V, C, hh, ww))
        h = self.proj_in(h.permute(0, 2, 3, 1))             # (BV, h, w, inner)
        t = h.reshape(B, V * hh * ww, -1)
        t = t + self.attn1(self.norm1(t))
        t = t.reshape(B * V, hh * ww, -1)
        t = t + self.attn2(self.norm2(t))
        t = t + self.ff(self.norm3(t))
        t = self.proj_out(t).reshape(B, V, hh, ww, C)
        return x + t.permute(0, 1, 4, 2, 3)


class SDEncoderTrunk(nn.Module):
    """Input (B, V, 15, H, W); output (B, V, ch·ch_mult[-1], H/8, W/8) =
    silu(norm_out(mid))."""

    def __init__(self, in_ch: int = 15, ch: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_in = Conv2d(in_ch, ch, 3, padding=1, dtype=dtype)
        self.down = nn.ModuleList()
        c = ch
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList([ResBlock(c, ch * mult,
                                                  dtype=dtype)])
            c = ch * mult
            if i < len(ch_mult) - 1:
                level.downsample = SDDownsample(c, dtype=dtype)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResBlock(c, c, dtype=dtype)
        self.mid.attn_1 = MVMidAttention(c, dtype=dtype)
        self.mid.block_2 = ResBlock(c, c, dtype=dtype)
        self.norm_out = GroupNorm32(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, V, C, H, W = x.shape
        h = self.conv_in(x.reshape(B * V, C, H, W))
        for level in self.down:
            h = level.block[0](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_1(h)
        h = self.mid.attn_1(h.reshape((B, V) + h.shape[1:]))
        h = self.mid.block_2(h.reshape((B * V,) + h.shape[2:]))
        h = F.silu(self.norm_out(h))
        return h.reshape((B, V) + h.shape[1:])
