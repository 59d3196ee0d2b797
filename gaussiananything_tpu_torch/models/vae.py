"""The release VAE's decoder (port of `PointVAE.decode` with
`release_parity=True`, `gaussiananything_tpu/models/vae.py:163-200`).

`pcd_structured_latent_space_vae_decoder_cascaded`
(`vit/vit_triplane.py:1211,1594`): post-quant MLP z → width, the DiT2
backbone on K query tokens, the surfel head to K base gaussians placed at
the anchors, then three upsamplers (f = 8, 4, 3) → four LoDs of activated
13-channel gaussians (768 → 6144 → 24,576 → 73,728 at release size).
Parameter names are the reference AE's (`decoder.vit_decoder.*`,
`decoder.superresolution.*`); the encoder is not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.dit2_decoder import DiT2
from gaussiananything_tpu_torch.models.layers import Mlp
from gaussiananything_tpu_torch.models.upsampler import GaussianUpsampler
from gaussiananything_tpu_torch.ops.gaussians import (POS_BOUND,
                                                      activate_gaussians_at)


def soft_clamp(x: torch.Tensor, v: float = 20.0) -> torch.Tensor:
    """x → v·tanh(x/v) (`soft_clamp20`, the KL logvar clamp)."""
    return v * torch.tanh(x / v)


class SurfelHead(nn.Module):
    """SiLU + Linear(width → 13) with the reference init contract
    (`vit/vit_triplane.py:287-341`): zero weights but rotation rows 1,
    biases 0 but raw scale `scale_bias` and rgb 0.5."""

    def __init__(self, width: int, scale_bias: float = -2.5):
        super().__init__()
        self.gaussian_pred = nn.Sequential(nn.SiLU(), nn.Linear(width, 13))
        lin = self.gaussian_pred[1]
        with torch.no_grad():
            lin.weight.zero_()
            lin.weight[6:10] = 1.0
            lin.bias.zero_()
            lin.bias[4:6] = scale_bias
            lin.bias[10:13] = 0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gaussian_pred(x)


class PointVAE(nn.Module):
    def __init__(self, latent_num: int = 768, z_channels: int = 10,
                 decoder_width: int = 768, decoder_depth: int = 12,
                 decoder_heads: int = 12,
                 up_factors: Sequence[int] = (8, 4, 3),
                 up_depths: Sequence[int] = (2, 1, 1),
                 skip_weight: float = 0.1, scale_bias: float = -2.5):
        super().__init__()
        self.skip_weight = skip_weight
        self.up_factors = tuple(up_factors)
        sr = nn.ModuleDict({
            # timm Mlp with hidden = in (`vit/vit_triplane.py:1318-1326`)
            "post_quant_conv": Mlp(z_channels, z_channels, decoder_width),
            "conv_sr": SurfelHead(decoder_width, scale_bias),
        })
        for k, (f, d) in enumerate(zip(up_factors, up_depths)):
            sr[f"ada_CA_f4_{k + 1}"] = GaussianUpsampler(decoder_width, f, d)
        self.decoder = nn.ModuleDict({
            "vit_decoder": DiT2(latent_num, decoder_width, decoder_depth,
                                decoder_heads),
            "superresolution": sr,
        })

    @classmethod
    def from_config(cls, vae_cfg) -> "PointVAE":
        """Build from a `config.VAEModelConfig` (release layout)."""
        return cls(latent_num=vae_cfg.latent_num,
                   z_channels=vae_cfg.z_channels,
                   decoder_width=vae_cfg.decoder_width,
                   decoder_depth=vae_cfg.decoder_depth,
                   decoder_heads=vae_cfg.decoder_heads,
                   up_factors=vae_cfg.up_factors, up_depths=vae_cfg.up_depths,
                   skip_weight=vae_cfg.skip_weight,
                   scale_bias=vae_cfg.scale_bias)

    def decode(self, z: torch.Tensor, anchors: torch.Tensor
               ) -> List[torch.Tensor]:
        """z (B, K, z_channels), anchors (B, K, 3) → the LoDs, activated
        gaussians (B, K·∏f, 13)."""
        sr = self.decoder["superresolution"]
        feat = self.decoder["vit_decoder"](sr["post_quant_conv"](z.float()))
        raw = sr["conv_sr"](feat)
        # the reference clips no position (`vit/vit_triplane.py:1388-1400`)
        half = POS_BOUND * 0.5
        pos = anchors.float() + torch.tanh(raw[..., 0:3]) \
            * (half * self.skip_weight)
        lods = [activate_gaussians_at(pos, raw)]
        parent_xyz = lods[0][..., 0:3]
        for k, f in enumerate(self.up_factors):
            feat, raw, residual = sr[f"ada_CA_f4_{k + 1}"](feat, raw)
            # child position = parent + tanh(RESIDUAL[:3])·0.225, unscaled
            # (`vit/vit_triplane.py:1040-1058`)
            pos = torch.repeat_interleave(parent_xyz, f, dim=1) \
                + torch.tanh(residual[..., 0:3]) * half
            lods.append(activate_gaussians_at(pos, raw))
            parent_xyz = lods[-1][..., 0:3]
        return lods
