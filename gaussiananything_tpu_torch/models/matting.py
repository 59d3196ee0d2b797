"""U²-Net salient-object matting, the `rembg` backbone (port of
`gaussiananything_tpu/models/matting.py`).

The reference removes the background of real conditioning images with
`rembg.remove` (`utils/infer_utils.py:4,27`), a pretrained U²-Net (Qin et
al. 2020, xuebinqin/U-2-Net `u2net.py`). The weights are not in the
repository; parameter names are the torch source's (`stageN[d].rebnconvK
[d].conv_s1`, `.bn_s1` with its running statistics, `sideN`, `outconv`),
so a converted `u2net.pth` loads name for name.

Inference only: BatchNorm applies the running statistics (eps 1e-5). NCHW;
H and W must be multiples of 32. Bilinear resizes use `jax.image.resize`
semantics (`utils/image.resize`, antialiased when shrinking), not
`F.interpolate`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaussiananything_tpu_torch.models.conditioner import (IMAGENET_MEAN,
                                                           IMAGENET_STD)
from gaussiananything_tpu_torch.utils.image import resize

BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm in inference form: (x − running_mean) · rsqrt(running_var
    + eps) · weight + bias."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return (x - self.running_mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


class REBNCONV(nn.Module):
    """conv3x3 (dilation d, "SAME") + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate,
                                 dilation=dirate)
        self.bn_s1 = FrozenBatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _upsample_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    return resize(src, tar.shape[-2:], "linear")


class RSU(nn.Module):
    """Residual U-block of height L (RSU7…RSU4): encoder convs 1…L with 2×
    pools between 1…L−1, the deepest at dilation 2, decoder convs
    (L−1)d…1d on concat(up(prev), skip); returns hx1d + hxin."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        ch = out_ch
        for i in range(1, height):
            setattr(self, f"rebnconv{i}", REBNCONV(ch, mid_ch))
            ch = mid_ch
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.height
        hxin = self.rebnconvin(x)
        enc = []
        h = hxin
        for i in range(1, L):
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i < L - 1:
                h = _pool2(h)
        h = getattr(self, f"rebnconv{L}")(h)
        for i in range(L - 1, 0, -1):
            skip = enc[i - 1]
            if i < L - 1:
                h = _upsample_like(h, skip)
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, skip], dim=1))
        return h + hxin


class RSU4F(nn.Module):
    """Dilation-only residual block: rates 1, 2, 4, 8 down and 4, 2, 1 up."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h = self.rebnconv3d(torch.cat([h4, h3], dim=1))
        h = self.rebnconv2d(torch.cat([h, h2], dim=1))
        h = self.rebnconv1d(torch.cat([h, h1], dim=1))
        return h + hxin


# (height or 0 for RSU4F, mid, out) per stage: torch U2NET(3, 1); u2netp
# uses mid 16 / out 64 everywhere
_U2NET_ENC = ((7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512),
              (0, 256, 512), (0, 256, 512))
_U2NET_DEC = ((0, 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64),
              (7, 16, 64))
_U2NETP_ENC = tuple((h, 16, 64) for h, _, _ in _U2NET_ENC)
_U2NETP_DEC = tuple((h, 16, 64) for h, _, _ in _U2NET_DEC)


def _make_rsu(cfg: Tuple[int, int, int], in_ch: int) -> nn.Module:
    height, mid, out = cfg
    if height == 0:
        return RSU4F(in_ch, mid, out)
    return RSU(height, in_ch, mid, out)


class U2Net(nn.Module):
    """6 encoder stages (2× pools between), 5 decoder stages, 7 side
    outputs fused by a 1×1 conv. (B, 3, H, W) → the fused saliency map
    (B, 1, H, W) in [0, 1]; `side_outputs=True` adds the 7 maps."""

    def __init__(self, enc_cfg: Sequence[Tuple[int, int, int]] = _U2NET_ENC,
                 dec_cfg: Sequence[Tuple[int, int, int]] = _U2NET_DEC):
        super().__init__()
        self.n_enc = len(enc_cfg)
        ch = 3
        enc_out = []
        for i, cfg in enumerate(enc_cfg):
            setattr(self, f"stage{i + 1}", _make_rsu(cfg, ch))
            ch = cfg[2]
            enc_out.append(ch)
        self.side6 = nn.Conv2d(ch, 1, 3, padding=1)
        for i, cfg in enumerate(dec_cfg):
            k = 5 - i                                 # 5d, 4d, 3d, 2d, 1d
            setattr(self, f"stage{k}d", _make_rsu(cfg, ch + enc_out[k - 1]))
            ch = cfg[2]
            setattr(self, f"side{k}", nn.Conv2d(ch, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x: torch.Tensor, side_outputs: bool = False):
        if x.shape[-2] % 32 or x.shape[-1] % 32:
            raise ValueError(f"U2Net needs sizes that are multiples of 32, "
                             f"got {tuple(x.shape)}")
        feats = []
        h = x.float()
        for i in range(self.n_enc):
            h = getattr(self, f"stage{i + 1}")(h)
            feats.append(h)
            if i < self.n_enc - 1:
                h = _pool2(h)
        sides = [self.side6(feats[-1])]
        h = feats[-1]
        for k in range(5, 0, -1):
            skip = feats[k - 1]
            h = getattr(self, f"stage{k}d")(
                torch.cat([_upsample_like(h, skip), skip], dim=1))
            sides.append(getattr(self, f"side{k}")(h))
        full = sides[-1]
        maps = [_upsample_like(s, full) for s in sides[::-1]]  # d1…d6
        out = torch.sigmoid(self.outconv(torch.cat(maps, dim=1)))
        if side_outputs:
            return out, [torch.sigmoid(m) for m in maps]
        return out


def u2net() -> U2Net:
    return U2Net()


def u2netp() -> U2Net:
    return U2Net(_U2NETP_ENC, _U2NETP_DEC)


@torch.no_grad()
def matting_alpha(net: U2Net, image: torch.Tensor, res: int = 320
                  ) -> torch.Tensor:
    """rembg's alpha: (H, W, 3) float in [0, 1] → (H, W) alpha in [0, 1].

    Resized to res² for the net, divided by its max (RescaleT), imagenet-
    normalised; the map is min-max normalised and resized back."""
    H, W = image.shape[:2]
    x = resize(image.float().permute(2, 0, 1), (res, res), "linear")
    x = x / torch.clamp(x.max(), min=1e-6)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    a = net(((x - mean) / std)[None])[0, 0]
    a = (a - a.min()) / torch.clamp(a.max() - a.min(), min=1e-6)
    return resize(a, (H, W), "linear")
