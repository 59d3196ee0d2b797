"""Point-cloud-structured 3D VAE: encoder, KL bottleneck and cascaded
gaussian decoder (port of `gaussiananything_tpu/models/vae.py`).

`pcd_structured_latent_space_vae_decoder_cascaded`
(`vit/vit_triplane.py:1211,1266,1594`) behind the `AE` façade
(`nsr/script_util.py:32,303-410`):

  encode: `HybridPCDEncoder` → (B, K, 2·z) and the anchors; quant MLP;
    `DiagonalGaussian` with the logvar soft-clamped to ±20;
  decode: post-quant MLP z → width, the DiT2 backbone on K query tokens,
    the surfel head to K base gaussians placed at the anchors, then the
    upsamplers (f = 8, 4, 3 at release size) → the LoDs of activated
    13-channel gaussians (768 → 6144 → 24,576 → 73,728).

Parameter names are the reference AE's (`encoder.*`, `decoder.vit_decoder.*`,
`decoder.superresolution.*`). Sampling builds the decoder alone
(`with_encoder=False`); training builds both. `dtype` is the compute
dtype of the encoder, the quant and post-quant MLPs, DiT2, the surfel head
and the upsamplers (`models/layers.py`, JAX `models/vae.py:124-148`); the
parameters, the latent statistics and the activated gaussians that reach
the rasterizer are fp32 whatever it is.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.dit2_decoder import DiT2
from gaussiananything_tpu_torch.models.encoder import HybridPCDEncoder
from gaussiananything_tpu_torch.models.layers import Linear, Mlp, XYZPosEmbed
from gaussiananything_tpu_torch.models.upsampler import GaussianUpsampler
from gaussiananything_tpu_torch.ops.gaussians import (POS_BOUND,
                                                      activate_gaussians,
                                                      activate_gaussians_at)
from gaussiananything_tpu_torch.utils import profiling


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std · noise; `noise` (the shape of mean) is drawn from
        `generator` when not given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype,
                                device=self.mean.device)
        return self.mean + torch.exp(0.5 * self.logvar) * noise

    def kl(self) -> torch.Tensor:
        """Per-sample KL to N(0, 1), summed over token and channel dims."""
        return 0.5 * (self.mean ** 2 + torch.exp(self.logvar) - 1.0
                      - self.logvar).flatten(1).sum(1)


def soft_clamp(x: torch.Tensor, v: float = 20.0) -> torch.Tensor:
    """x → v·tanh(x/v) (`soft_clamp20`, the KL logvar clamp)."""
    return v * torch.tanh(x / v)


class SurfelHead(nn.Module):
    """SiLU + Linear(width → 13) with the reference init contract
    (`vit/vit_triplane.py:287-341`): zero weights but rotation rows 1,
    biases 0 but raw scale `scale_bias` and rgb 0.5."""

    def __init__(self, width: int, scale_bias: float = -2.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gaussian_pred = nn.Sequential(nn.SiLU(),
                                           Linear(width, 13, dtype=dtype))
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
    """release_parity (the default, the official checkpoint's layout): the
    parity encoder, no anchor position embedding in the decoder's
    conditioning and unscaled upsample offsets. Otherwise the anchors'
    Fourier embedding joins the conditioning (`anchor_pe`) and every level
    activates through `activate_gaussians` with `skip_weight`.

    with_encoder: also build the encoder and the quant MLP (training);
    without them only `decode` works (sampling).
    """

    def __init__(self, latent_num: int = 768, z_channels: int = 10,
                 decoder_width: int = 768, decoder_depth: int = 12,
                 decoder_heads: int = 12,
                 up_factors: Sequence[int] = (8, 4, 3),
                 up_depths: Sequence[int] = (2, 1, 1),
                 skip_weight: float = 0.1, scale_bias: float = -2.5,
                 release_parity: bool = True, with_encoder: bool = False,
                 encoder_width: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_weight = skip_weight
        self.latent_shape = (latent_num, z_channels)
        self.up_factors = tuple(up_factors)
        self.release_parity = release_parity
        self.dtype = dtype
        sr = nn.ModuleDict({
            # timm Mlp with hidden = in (`vit/vit_triplane.py:1318-1326`)
            "post_quant_conv": Mlp(z_channels, z_channels, decoder_width,
                                   dtype=dtype),
            "conv_sr": SurfelHead(decoder_width, scale_bias, dtype=dtype),
        })
        if with_encoder:
            sr["quant_conv"] = Mlp(2 * z_channels, 2 * z_channels,
                                   2 * z_channels, dtype=dtype)
        if not release_parity:
            sr["anchor_pe"] = XYZPosEmbed(decoder_width, dtype=dtype)
        for k, (f, d) in enumerate(zip(up_factors, up_depths)):
            sr[f"ada_CA_f4_{k + 1}"] = GaussianUpsampler(
                decoder_width, f, d, release_parity=release_parity,
                dtype=dtype)
        self.decoder = nn.ModuleDict({
            "vit_decoder": DiT2(latent_num, decoder_width, decoder_depth,
                                decoder_heads,
                                release_parity=release_parity, dtype=dtype),
            "superresolution": sr,
        })
        self.encoder = HybridPCDEncoder(
            latent_num=latent_num, z_channels=z_channels,
            width=encoder_width, release_parity=release_parity,
            dtype=dtype) if with_encoder else None

    @classmethod
    def from_config(cls, vae_cfg, with_encoder: bool = False,
                    dtype: torch.dtype = None) -> "PointVAE":
        """Build from a `config.VAEModelConfig`; `dtype` defaults to its
        `compute_dtype`."""
        from gaussiananything_tpu_torch.config import compute_dtype
        return cls(latent_num=vae_cfg.latent_num,
                   z_channels=vae_cfg.z_channels,
                   decoder_width=vae_cfg.decoder_width,
                   decoder_depth=vae_cfg.decoder_depth,
                   decoder_heads=vae_cfg.decoder_heads,
                   up_factors=vae_cfg.up_factors, up_depths=vae_cfg.up_depths,
                   skip_weight=vae_cfg.skip_weight,
                   scale_bias=vae_cfg.scale_bias,
                   release_parity=vae_cfg.release_parity,
                   with_encoder=with_encoder,
                   encoder_width=vae_cfg.encoder_width,
                   dtype=dtype or compute_dtype(vae_cfg.compute_dtype))

    def encode(self, images: torch.Tensor, pcd: torch.Tensor
               ) -> Tuple[DiagonalGaussian, torch.Tensor]:
        """images (B, V, 15, H, W), pcd (B, P, 3) → the latent posterior
        and the anchors (B, K, 3). The statistics are fp32."""
        if self.encoder is None:
            raise RuntimeError("this PointVAE was built without its encoder")
        with profiling.span("ga.encode"):
            h, anchors = self.encoder(images, pcd)
            moments = self.decoder["superresolution"]["quant_conv"](h) \
                .float()
            mean, logvar = moments.chunk(2, dim=-1)
            return DiagonalGaussian(mean, soft_clamp(logvar)), anchors

    def decode(self, z: torch.Tensor, anchors: torch.Tensor
               ) -> List[torch.Tensor]:
        """z (B, K, z_channels), anchors (B, K, 3) → the LoDs, activated
        gaussians (B, K·∏f, 13)."""
        sr = self.decoder["superresolution"]
        c = sr["post_quant_conv"](z.float())
        if not self.release_parity:
            # the latent tokens are the only conditioning, so the anchor
            # geometry joins them through Fourier features
            c = c + sr["anchor_pe"](anchors)
        feat = self.decoder["vit_decoder"](c)
        raw = sr["conv_sr"](feat)
        half = POS_BOUND * 0.5
        if self.release_parity:
            # the reference clips no position
            # (`vit/vit_triplane.py:1388-1400`)
            pos = anchors.float() + torch.tanh(raw[..., 0:3].float()) \
                * (half * self.skip_weight)
            lods = [activate_gaussians_at(pos, raw)]
        else:
            lods = [activate_gaussians(raw, anchors, self.skip_weight)]
        parent_xyz = lods[0][..., 0:3]
        for k, f in enumerate(self.up_factors):
            feat, raw, residual = sr[f"ada_CA_f4_{k + 1}"](feat, raw,
                                                             parent_xyz)
            rep_parent = torch.repeat_interleave(parent_xyz, f, dim=1)
            if self.release_parity:
                # child position = parent + tanh(RESIDUAL[:3])·0.225,
                # unscaled (`vit/vit_triplane.py:1040-1058`)
                pos = rep_parent + torch.tanh(residual[..., 0:3].float()) \
                    * half
                lods.append(activate_gaussians_at(pos, raw))
            else:
                lods.append(activate_gaussians(raw, rep_parent,
                                               self.skip_weight))
            parent_xyz = lods[-1][..., 0:3]
        return lods

    def forward(self, images: torch.Tensor, pcd: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        dist, anchors = self.encode(images, pcd)
        z = dist.sample(noise, generator)
        return {"lods": self.decode(z, anchors), "kl": dist.kl(),
                "mean": dist.mean, "logvar": dist.logvar,
                "anchors": anchors, "z": z}

    def latent_for_diffusion(self, images: torch.Tensor, pcd: torch.Tensor,
                             noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             xyz_scale: float = 0.164) -> torch.Tensor:
        """(kl_z ‖ anchors / xyz_scale) per token; 0.164 is
        `datasets/g_buffer_objaverse.py:3645`."""
        dist, anchors = self.encode(images, pcd)
        return torch.cat([dist.sample(noise, generator),
                          anchors / xyz_scale], dim=-1)
