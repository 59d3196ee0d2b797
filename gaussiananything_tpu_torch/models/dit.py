"""The release flow-matching point DiTs (port of the `release_parity=True`
layout of `gaussiananything_tpu/models/dit.PointDiT`).

  * stage 1, `DiT-PixArt-PCD-CLAY-L` = `DiT_I23D_PCD_PixelArt_noclip`
    (`dit/dit_i23d.py:437,1516-1524`): denoises 768×3 point tokens;
  * stage 2, `…_clay_stage2` (`dit/dit_i23d.py:664`): denoises 768×10 KL
    tokens with the stage-1 xyz added through `xyz_pos_embed`.

Raw t ∈ [0, 1] feeds the timestep embedder; t-embedding + LN/Linear pooled
vector drive one shared adaLN; every CLAY block cross-attends the raw DINOv2
tokens (bias-less, qk-normed), then runs adaLN-gated qk-norm self-attention
and an exact-GELU MLP; the T2I final layer adds a (2, D) table to the
combined embedding. Parameter names are the reference's state-dict names.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.layers import (Attention,
                                                      CrossAttention, Mlp,
                                                      RMSNorm,
                                                      TimestepEmbedder,
                                                      XYZPosEmbed, exact_gelu,
                                                      modulate)


class ClayDiTBlock(nn.Module):
    """`ImageCondDiTBlockPixelArtRMSNormClayLRM`
    (`dit/dit_models_xformers.py:717-787`): CA → SA → FFN."""

    def __init__(self, dim: int, heads: int, ctx_dim: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = RMSNorm(dim)
        self.norm2 = RMSNorm(dim)
        self.attn = Attention(dim, heads, qk_norm=True)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=exact_gelu)
        self.scale_shift_table = nn.Parameter(
            torch.randn(6, dim) * (0.02 / dim ** 0.5))
        self.cross_attn_dino = CrossAttention(dim, ctx_dim, heads,
                                              dim_head=dim // heads,
                                              qk_norm=True)
        self.prenorm_ca_dino = RMSNorm(dim)

    def forward(self, x: torch.Tensor, cond_tokens: torch.Tensor,
                ada: torch.Tensor) -> torch.Tensor:
        """x (B,N,D); cond_tokens (B,L,C); ada (B,6,D) shared adaLN."""
        mod = ada + self.scale_shift_table[None]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (mod[:, i, None] for i in range(6))
        x = x + self.cross_attn_dino(self.prenorm_ca_dino(x), cond_tokens)
        x = x + g_a * self.attn(modulate(self.norm1(x), sh_a, sc_a))
        return x + g_m * self.mlp(modulate(self.norm2(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    """`T2IFinalLayer` (`dit/dit_models_xformers.py:62-85`)."""

    def __init__(self, dim: int, out_ch: int):
        super().__init__()
        self.norm_final = nn.LayerNorm(dim, elementwise_affine=False,
                                       eps=1e-6)
        self.linear = nn.Linear(dim, out_ch)
        self.scale_shift_table = nn.Parameter(
            torch.randn(2, dim) * (0.02 / dim ** 0.5))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        t2 = self.scale_shift_table[None] + c[:, None, :]
        shift, scale = t2[:, 0, None], t2[:, 1, None]
        return self.linear(modulate(self.norm_final(x), shift, scale))


class PointDiT(nn.Module):
    def __init__(self, in_channels: int = 3, width: int = 1024,
                 depth: int = 24, heads: int = 16, cond_dim: int = 1024,
                 vector_dim: int = 1024, use_xyz_pe: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.width = width
        self.x_embedder = Mlp(in_channels, width, width)
        self.t_embedder = TimestepEmbedder(width)
        self.pooled_vec_embedder = nn.Sequential(
            nn.LayerNorm(vector_dim, eps=1e-5), nn.Linear(vector_dim, width))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(width, 6 * width))
        self.blocks = nn.ModuleList([ClayDiTBlock(width, heads, cond_dim)
                                     for _ in range(depth)])
        self.final_layer = FinalLayer(width, in_channels)
        self.xyz_pos_embed = XYZPosEmbed(width) if use_xyz_pe else None

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_tokens: torch.Tensor, cond_vector: torch.Tensor,
                xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,N,in_channels); t (B,) in [0,1]; cond_tokens (B,L,cond_dim);
        cond_vector (B,vector_dim); xyz (B,N,3) for stage 2 → velocity
        (B,N,in_channels), fp32."""
        h = self.x_embedder(x.float())
        if self.xyz_pos_embed is not None:
            if xyz is None:
                raise ValueError("the stage-2 DiT needs the stage-1 xyz")
            h = h + self.xyz_pos_embed(xyz)
        c = self.t_embedder(t) + self.pooled_vec_embedder(cond_vector.float())
        ada = self.adaLN_modulation(c).reshape(c.shape[0], 6, self.width)
        ctx = cond_tokens.float()
        for blk in self.blocks:
            h = blk(h, ctx, ada)
        return self.final_layer(h, c).float()


def stage1_dit_release(**kw) -> PointDiT:
    """The released stage-1 geometry denoiser (i23d-stage1.sh)."""
    cfg = dict(depth=24, width=1024, heads=16, cond_dim=1024,
               vector_dim=1024)
    cfg.update(kw)
    return PointDiT(in_channels=3, use_xyz_pe=False, **cfg)


def stage2_dit_release(**kw) -> PointDiT:
    """The released stage-2 texture denoiser (i23d-stage2.sh)."""
    cfg = dict(depth=24, width=1024, heads=16, cond_dim=1024,
               vector_dim=1024)
    cfg.update(kw)
    return PointDiT(in_channels=10, use_xyz_pe=True, **cfg)
