"""Multi-view VAE encoder (port of `gaussiananything_tpu/models/encoder.py`).

`HybridEncoderPCDStructuredLatentSNoPCD` (`nsr/srt/encoder.py:454-610`):
conv downsample (f = 8) over each posed 15-channel view → all views' tokens
in one set → Fourier position embedding of each token's unprojected xyz
(the input's xyz channels at the token centres, `:565`) → K farthest-point
anchors of the surface point cloud (`:533-538`) → the anchors cross-attend
to the tokens (`agg_ca`, `:475-479,594`) → a small SRT transformer
(`:461-468,602`) → pre-norm MLP to 2·z_channels (`:487-494,604`).
`dtype` is the compute dtype (`models/layers.py`), as the JAX encoder's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaussiananything_tpu_torch.models.layers import (
    Attention, CrossAttention, CrossAttentionBlock, GroupNorm32, LayerNorm,
    Linear, Mlp, ResBlock, SameConv2d, TransformerBlock, XYZPosEmbed,
    exact_gelu)
from gaussiananything_tpu_torch.models.sd_encoder import SDEncoderTrunk
from gaussiananything_tpu_torch.ops.fps import sample_farthest_points
from gaussiananything_tpu_torch.utils import profiling


class MVConvEncoder(nn.Module):
    """SD-style conv encoder whose mid-block attention is joint over all
    views (`ldm/modules/diffusionmodules/model.py:469,574`, `MVEncoder`).
    Input (B, V, C_in, H, W); output (B, V, out_ch, H/8, W/8)."""

    def __init__(self, in_ch: int = 15, ch: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), out_ch: int = 256,
                 heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_in = SameConv2d(in_ch, ch, 3, dtype=dtype)
        self.blocks = nn.ModuleList()
        self.downs = nn.ModuleList()
        c = ch
        for i, mult in enumerate(ch_mult):
            self.blocks.append(ResBlock(c, ch * mult, dtype=dtype))
            c = ch * mult
            if i < len(ch_mult) - 1:
                self.downs.append(SameConv2d(c, c, 3, stride=2, dtype=dtype))
        self.mid_block_1 = ResBlock(c, c, dtype=dtype)
        self.mid_norm = LayerNorm(c, eps=1e-6)
        self.mid_attn = Attention(c, heads, dtype=dtype)
        self.mid_block_2 = ResBlock(c, c, dtype=dtype)
        self.norm_out = GroupNorm32(c)
        self.conv_out = SameConv2d(c, out_ch, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, V, C, H, W = x.shape
        h = self.conv_in(x.reshape(B * V, C, H, W))
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i < len(self.downs):
                h = self.downs[i](h)
        h = self.mid_block_1(h)
        c, hh, ww = h.shape[1:]
        tokens = h.reshape(B, V, c, hh * ww).permute(0, 1, 3, 2) \
            .reshape(B, V * hh * ww, c)
        tokens = tokens + self.mid_attn(self.mid_norm(tokens))
        h = tokens.reshape(B * V, hh, ww, c).permute(0, 3, 1, 2)
        h = self.mid_block_2(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.reshape(B, V, -1, hh, ww)


class HybridPCDEncoder(nn.Module):
    """The pcd-structured latent encoder: returns (latent (B, K, 2·z),
    anchor xyz (B, K, 3)).

    images (B, V, 15, H, W) with xyz in the last three channels
    (`nsr/srt/encoder.py:552`); pcd (B, P, 3) is the surface point cloud.

    release_parity: the layout of the official checkpoint
    (`nsr/srt/encoder.py:648-653`): the SD trunk, ONE xyz position
    embedding for tokens and anchors, a bare aggregation cross-attention
    over the image tokens only whose output replaces the query, exact-GELU
    SRT MLPs; it runs at the conv trunk's width (256). Otherwise: the
    `MVConvEncoder`, separate embeddings, and a residual cross-attention
    block over the image tokens and the embedded point cloud.
    """

    def __init__(self, latent_num: int = 768, z_channels: int = 10,
                 width: int = 384, conv_ch: int = 64, conv_out: int = 256,
                 srt_depth: int = 3, heads: int = 8, downsample: int = 8,
                 release_parity: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_num = latent_num
        self.downsample = downsample
        self.release_parity = release_parity
        if release_parity:
            if width != conv_out:
                raise ValueError("parity mode runs at the conv trunk width "
                                 f"({conv_out}), got width={width}")
            self.sd_trunk = SDEncoderTrunk(ch=conv_ch, dtype=dtype)
            self.xyz_pos_embed = XYZPosEmbed(width, dtype=dtype)
            self.agg_ca = CrossAttention(width, width, heads, dim_head=64,
                                         qk_norm=True, qkv_bias=False,
                                         dtype=dtype)
        else:
            self.conv = MVConvEncoder(ch=conv_ch, out_ch=conv_out,
                                      heads=heads, dtype=dtype)
            self.token_proj = Linear(conv_out, width, dtype=dtype)
            self.token_embed = XYZPosEmbed(width, dtype=dtype)
            self.anchor_embed = XYZPosEmbed(width, dtype=dtype)
            self.agg_ca = CrossAttentionBlock(width, heads, qk_norm=True,
                                              dtype=dtype)
        kw = dict(qk_norm=True, act=exact_gelu) if release_parity else {}
        self.srt = nn.ModuleList(
            [TransformerBlock(width, heads, dtype=dtype, **kw)
             for _ in range(srt_depth)])
        self.norm_out = LayerNorm(width, eps=1e-5)
        self.mlp_out = Mlp(width, width, 2 * z_channels, dtype=dtype)

    def forward(self, images: torch.Tensor, pcd: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, V, C, H, W = images.shape
        if C != 15:
            raise ValueError("expected 15-channel rgb+normal+plucker+xyz, "
                             f"got {C}")
        with profiling.span("ga.encode.trunk"):
            feat = self.sd_trunk(images) if self.release_parity \
                else self.conv(images)
        c = feat.shape[2]
        tokens = feat.flatten(3).permute(0, 1, 3, 2).reshape(B, -1, c)
        # token-centre xyz from the input xyz channels (stride f, offset f/2)
        f = self.downsample
        tok_xyz = images[:, :, -3:, f // 2::f, f // 2::f]
        tok_xyz = tok_xyz.flatten(3).permute(0, 1, 3, 2).reshape(B, -1, 3)

        anchors, _ = sample_farthest_points(pcd, self.latent_num)
        with profiling.span("ga.encode.agg"):
            if self.release_parity:
                tokens = tokens + self.xyz_pos_embed(tok_xyz)
                q = self.agg_ca(self.xyz_pos_embed(anchors), tokens)
            else:
                tokens = self.token_proj(tokens) + self.token_embed(tok_xyz)
                # the queries are the point cloud's embedding at the anchors
                kv = torch.cat([tokens, self.anchor_embed(pcd)], dim=1)
                q = self.agg_ca(self.anchor_embed(anchors), kv)
            for block in self.srt:
                q = block(q)
            return self.mlp_out(self.norm_out(q)), anchors
