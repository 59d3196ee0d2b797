"""Cascaded gaussian upsampler (port of
`gaussiananything_tpu/models/upsampler.py`).

`GS_Adaptive_Read_Write_CA_adaptive_2dgs` (`vit/vit_triplane.py:426-1065`):
each parent's feature and f learned query tokens form an (f+1)-token group
that runs through a small pre-norm transformer (heads D/64, qk-norm, exact
GELU); a pre-norm linear head gives the 13-channel residual, and the
children's raw parameters are the parent's, repeated f times, plus it.
Without `release_parity` the queries also carry the parent's xyz embedding
(`xyz_embed`) and the transformer has 8 heads, no qk-norm, tanh GELU.
`dtype` is the compute dtype (`models/layers.py`); the query table enters
cast to it, as the JAX upsampler's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.layers import (Linear, PreNorm,
                                                      Transformer,
                                                      XYZPosEmbed, exact_gelu)


class GaussianUpsampler(nn.Module):
    def __init__(self, dim: int, factor: int, depth: int = 1,
                 release_parity: bool = True, heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.factor = factor
        self.dtype = dtype
        self.latent_embedding = nn.Parameter(
            torch.randn(1, factor, dim) * 0.02)
        if release_parity:
            self.xyz_embed = None
            self.transformer = Transformer(dim, depth, dim // 64,
                                           qk_norm=True, act=exact_gelu,
                                           dtype=dtype)
        else:
            self.xyz_embed = XYZPosEmbed(dim, dtype=dtype)
            self.transformer = Transformer(dim, depth, heads, dtype=dtype)
        self.gaussian_residual_pred = PreNorm(dim, Linear(dim, 13,
                                                          dtype=dtype))

    def forward(self, feat: torch.Tensor, raw_gaussians: torch.Tensor,
                parent_xyz: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """feat (B, N, D) parent features; raw_gaussians (B, N, 13) parent
        pre-activations; parent_xyz (B, N, 3) activated parent positions
        (read only without `release_parity`) → (child_feat (B, N·f, D),
        child_raw (B, N·f, 13),
        residual (B, N·f, 13)); the caller forms child positions from the
        residual alone (`vit/vit_triplane.py:1044-1049`)."""
        B, N, D = feat.shape
        f = self.factor
        q = self.latent_embedding.expand(B * N, -1, -1).to(self.dtype)
        if self.xyz_embed is not None:
            q = q + self.xyz_embed(parent_xyz).reshape(B * N, 1, D)
        grp = torch.cat([feat.reshape(B * N, 1, D), q], dim=1)
        child_feat = self.transformer(grp)[:, 1:].reshape(B, N * f, D)
        residual = self.gaussian_residual_pred(child_feat)
        child_raw = torch.repeat_interleave(raw_gaussians, f, dim=1) \
            + residual
        return child_feat, child_raw, residual
