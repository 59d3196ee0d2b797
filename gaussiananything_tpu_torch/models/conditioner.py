"""The release image conditioner (port of the `backbone="dinov2"` branch of
`gaussiananything_tpu/models/conditioner.ImageConditioner`).

FrozenDinov2ImageEmbedder parity (`sgm/modules/encoders/modules.py:791-933`,
`output_cls=True`): any input is bicubic-resized to the native size,
imagenet-normalised, and the DINOv2 patch tokens become the cross-attention
context, the cls token the pooled vector.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
from gaussiananything_tpu_torch.utils.image import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Conditioning(NamedTuple):
    crossattn: torch.Tensor   # (B, L, D) token context
    vector: torch.Tensor      # (B, D) pooled context


class ImageConditioner(nn.Module):
    def __init__(self, width: int = 1024, depth: int = 24, heads: int = 16,
                 img_size: int = 518):
        super().__init__()
        self.img_size = img_size
        self.vit = Dinov2ViT(width=width, depth=depth, heads=heads,
                             img_size=img_size)

    def forward(self, images: torch.Tensor) -> Conditioning:
        """images (B, 3, H, W) in [0, 1]."""
        if images.shape[-1] != self.img_size:
            images = resize(images, (self.img_size, self.img_size), "cubic")
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        x = (images.float() - mean[:, None, None]) / std[:, None, None]
        patch_tokens, cls_tok = self.vit(x)
        return Conditioning(crossattn=patch_tokens, vector=cls_tok)
