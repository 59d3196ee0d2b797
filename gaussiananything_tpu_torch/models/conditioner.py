"""The conditioners (port of `gaussiananything_tpu/models/conditioner.py`).

  * `ImageConditioner`, `backbone="dinov2"` (the release path,
    FrozenDinov2ImageEmbedder parity, `sgm/modules/encoders/modules.py:
    791-933`, `output_cls=True`): any input is bicubic-resized to the native
    size, imagenet-normalised, and the DINOv2 patch tokens become the
    cross-attention context, the cls token the pooled vector;
    `backbone="scratch"`: the JAX package's trainable `VisionTransformer`,
    whose tokens (cls, 4 registers, patches) are all context.
  * `TextConditioner`, `backbone="bytes"`: the byte-token
    `TextTransformer`; `backbone="openclip"`: the CLIP ViT-L/14 text tower
    (`models/openclip_text.OpenClipTextTower`) for BPE ids
    (FrozenOpenCLIPEmbedder2 parity).

In training mode (`module.train()`) both zero a sample's whole conditioning,
tokens and pooled vector, with probability `ucg_rate`: the
classifier-free-guidance dropout (`sgm/modules/encoders/modules.py:
159-166`), whose zeros are the unconditional branch that sampling uses
(`unconditional`, or `torch.zeros_like` in `make_sampler`). The keep mask
(B, 1, 1) is drawn from a `torch.Generator` on the host, or given.
`dtype` is the compute dtype (`models/layers.py`): the parameters are
fp32; the embeddings and the learned tokens enter the blocks cast to it,
and the final norms return fp32, as the JAX backbones do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
from gaussiananything_tpu_torch.models.layers import (LayerNorm, SameConv2d,
                                                      TransformerBlock,
                                                      get_2d_sincos_pos_embed)
from gaussiananything_tpu_torch.utils.image import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Conditioning(NamedTuple):
    crossattn: torch.Tensor   # (B, L, D) token context
    vector: torch.Tensor      # (B, D) pooled context


def ucg_keep_mask(batch: int, ucg_rate: float,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """(batch, 1, 1) float keep mask, 1 with probability 1 − ucg_rate
    (`jax.random.bernoulli`: a uniform draw below 1 − ucg_rate)."""
    return (torch.rand((batch, 1, 1), generator=generator)
            < 1.0 - ucg_rate).float()


def _ucg_dropout(cond: "Conditioning", ucg_rate: float, training: bool,
                 generator: Optional[torch.Generator],
                 keep: Optional[torch.Tensor]) -> "Conditioning":
    if not (training and ucg_rate > 0):
        return cond
    if keep is None:
        keep = ucg_keep_mask(cond.vector.shape[0], ucg_rate, generator)
    keep = keep.to(cond.crossattn.device, cond.crossattn.dtype)
    return Conditioning(crossattn=cond.crossattn * keep,
                        vector=cond.vector * keep[:, 0].to(cond.vector.dtype))


def _imagenet_normalise(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() - mean[:, None, None]) / std[:, None, None]


class VisionTransformer(nn.Module):
    """DINOv2-style ViT with register tokens (the JAX package's scratch
    backbone): imagenet normalisation, a patch conv ("SAME"), the 2D sin-cos
    table, cls + registers + patches through pre-norm blocks (LayerNorm eps
    1e-5), a final LayerNorm (eps 1e-6) → (tokens, tokens[:, 0])."""

    def __init__(self, patch: int = 14, width: int = 1024, depth: int = 24,
                 heads: int = 16, num_registers: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width = width
        self.patch_embed = SameConv2d(3, width, patch, stride=patch,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.randn(1, 1, width) * 0.02)
        self.reg_tokens = nn.Parameter(
            torch.randn(1, num_registers, width) * 0.02)
        self.blocks = nn.ModuleList([TransformerBlock(width, heads,
                                                      dtype=dtype)
                                     for _ in range(depth)])
        self.norm = LayerNorm(width, eps=1e-6)

    def forward(self, images: torch.Tensor):
        """images (B, 3, H, W) in [0, 1]."""
        B = images.shape[0]
        x = self.patch_embed(_imagenet_normalise(images))   # (B, D, g, g)
        g = x.shape[-1]
        x = x.flatten(2).transpose(1, 2)
        pos = torch.from_numpy(get_2d_sincos_pos_embed(self.width, g))
        x = x + pos.to(x.device, x.dtype)[None]
        x = torch.cat([self.cls_token.expand(B, -1, -1).to(x.dtype),
                       self.reg_tokens.expand(B, -1, -1).to(x.dtype), x],
                      dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x, x[:, 0]


class ImageConditioner(nn.Module):
    def __init__(self, width: int = 1024, depth: int = 24, heads: int = 16,
                 img_size: int = 518, backbone: str = "dinov2",
                 ucg_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.ucg_rate = ucg_rate
        self.width = width
        self.backbone = backbone
        if backbone == "dinov2":
            self.vit = Dinov2ViT(width=width, depth=depth, heads=heads,
                                 img_size=img_size, dtype=dtype)
        elif backbone == "scratch":
            self.vit = VisionTransformer(width=width, depth=depth,
                                         heads=heads, dtype=dtype)
        else:
            raise ValueError(f"unknown image backbone {backbone!r}")

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> Conditioning:
        """images (B, 3, H, W) in [0, 1]. In training mode, the ucg
        dropout: `keep` (B, 1, 1), else drawn from `generator`."""
        if self.backbone == "scratch":
            tokens, pooled = self.vit(images)
        else:
            if images.shape[-1] != self.img_size:
                images = resize(images, (self.img_size, self.img_size),
                                "cubic")
            tokens, pooled = self.vit(_imagenet_normalise(images))
        return _ucg_dropout(Conditioning(crossattn=tokens, vector=pooled),
                            self.ucg_rate, self.training, generator, keep)

    def unconditional(self, batch: int) -> Conditioning:
        n_extra = 1 + 4 if self.backbone == "scratch" else 0
        L = (self.img_size // 14) ** 2 + n_extra
        return Conditioning(crossattn=torch.zeros((batch, L, self.width)),
                            vector=torch.zeros((batch, self.width)))


class TextTransformer(nn.Module):
    """Byte-token text encoder: embedding + learned positions, pre-norm
    blocks, a final LayerNorm (eps 1e-6); pooled = the mean over the
    non-pad tokens."""

    def __init__(self, vocab: int = 257, width: int = 768, depth: int = 12,
                 heads: int = 12, max_len: int = 77,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Embedding(vocab, width)
        self.pos = nn.Parameter(torch.randn(1, max_len, width) * 0.01)
        self.blocks = nn.ModuleList([TransformerBlock(width, heads,
                                                      dtype=dtype)
                                     for _ in range(depth)])
        self.norm = LayerNorm(width, eps=1e-6)

    def forward(self, token_ids: torch.Tensor):
        """token_ids (B, max_len) int → (tokens (B, L, width), pooled)."""
        x = self.embed(token_ids).to(self.dtype) + self.pos.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        mask = (token_ids > 0).float()[..., None]
        pooled = (x * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        return x, pooled


def tokenize_bytes(texts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """UTF-8 bytes + 1, zero-padded and cut to max_len → (B, max_len)
    int32."""
    out = np.zeros((len(texts), max_len), np.int32)
    for i, t in enumerate(texts):
        b = t.encode("utf-8")[: max_len]
        out[i, : len(b)] = np.frombuffer(b, np.uint8).astype(np.int32) + 1
    return out


class TextConditioner(nn.Module):
    def __init__(self, width: int = 768, depth: int = 12, heads: int = 12,
                 max_len: int = 77, backbone: str = "bytes",
                 ucg_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width = width
        self.ucg_rate = ucg_rate
        self.max_len = max_len
        if backbone == "openclip":
            from gaussiananything_tpu_torch.models.openclip_text import \
                OpenClipTextTower
            self.text = OpenClipTextTower(width=width, depth=depth,
                                          heads=heads, max_len=max_len,
                                          embed_dim=width, dtype=dtype)
        elif backbone == "bytes":
            self.text = TextTransformer(width=width, depth=depth,
                                        heads=heads, max_len=max_len,
                                        dtype=dtype)
        else:
            raise ValueError(f"unknown text backbone {backbone!r}")

    def forward(self, token_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> Conditioning:
        """token_ids (B, max_len); the ucg dropout, `generator` and
        `keep` as for `ImageConditioner`."""
        tokens, pooled = self.text(token_ids)
        return _ucg_dropout(Conditioning(crossattn=tokens, vector=pooled),
                            self.ucg_rate, self.training, generator, keep)

    def unconditional(self, batch: int) -> Conditioning:
        return Conditioning(
            crossattn=torch.zeros((batch, self.max_len, self.width)),
            vector=torch.zeros((batch, self.width)))
