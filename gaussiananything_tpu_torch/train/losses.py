"""Loss stack for VAE training (port of
`gaussiananything_tpu/train/losses.py`).

`E3DGELossClass` / `E3DGE_with_AdvLoss` (the reference's `nsr/losses`,
lines 356, 530-653, 776-826 of its main file): 2D reconstruction (L1/MSE,
optionally masked), a perceptual term, alpha loss, scale-invariant depth,
KL with linear annealing, the 2DGS normal-consistency and depth-distortion
regularisers (`nsr/train_nv_util.py:2158-2175`), the scale/opacity
regularisers (`:2143-2155`) and the PatchGAN hinge adversarial loss
(`nsr/losses/disc.py`).

The perceptual term is VGG16-LPIPS when its weights are given (a
`VGGLPIPS` loaded from an npz, `utils/param_io.load_params_npz`); without
them it is the JAX package's fallback, a fixed conv pyramid whose weights
come from a seed.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaussiananything_tpu_torch.models.layers import SameConv2d


def _masked_mean(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `d` where the (broadcastable) mask is on; the element count
    is the mask's sum at the full broadcast shape."""
    d, m = torch.broadcast_tensors(d, mask.to(d.dtype))
    return (d * m).sum() / (m.sum() + 1e-8)


def l1(a, b, mask=None):
    d = (a - b).abs()
    return d.mean() if mask is None else _masked_mean(d, mask)


def mse(a, b, mask=None):
    d = (a - b) ** 2
    return d.mean() if mask is None else _masked_mean(d, mask)


# ----------------------------------------------------------- perceptual

class PerceptualNet(nn.Module):
    """Fixed conv pyramid: 4 stages of a stride-2 and a stride-1 3x3 conv
    (32, 64, 128, 256 channels), each followed by ReLU; returns the four
    stage outputs. Input (B, 3, H, W) in [0, 1]. Parameters `conv{i}a`,
    `conv{i}b`."""

    def __init__(self):
        super().__init__()
        c_in, ch = 3, 32
        for i in range(4):
            setattr(self, f"conv{i}a", SameConv2d(c_in, ch, 3, stride=2))
            setattr(self, f"conv{i}b", SameConv2d(ch, ch, 3))
            c_in, ch = ch, ch * 2

    def forward(self, x: torch.Tensor):
        feats = []
        h = x * 2 - 1
        for i in range(4):
            h = F.relu(getattr(self, f"conv{i}a")(h))
            h = F.relu(getattr(self, f"conv{i}b")(h))
            feats.append(h)
        return feats


@functools.lru_cache(maxsize=4)
def default_perceptual_net(device: str = "cpu", seed: int = 0
                           ) -> PerceptualNet:
    """The frozen pyramid with weights drawn from `seed` (fan-in scaled
    normal kernels, zero biases), built once per device."""
    net = PerceptualNet()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=g)
                        / math.sqrt(fan_in))
            else:
                p.zero_()
    return net.to(device).requires_grad_(False)


def perceptual_loss(a: torch.Tensor, b: torch.Tensor,
                    net: Optional[nn.Module] = None) -> torch.Tensor:
    """a, b (B, 3, H, W) in [0, 1]. A `VGGLPIPS` net gives `lpips_vgg`;
    otherwise, per stage of the pyramid, the mean squared difference of the
    channel-normalised features, summed over the stages. `net=None` takes
    `default_perceptual_net` on a's device."""
    if isinstance(net, VGGLPIPS):
        return lpips_vgg(a, b, net)
    if net is None:
        net = default_perceptual_net(str(a.device))
    total = 0.0
    for xa, xb in zip(net(a), net(b)):
        na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-8)
        nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-8)
        total = total + ((na - nb) ** 2).mean()
    return total


# ------------------------------------------------------ VGG16 LPIPS

# torchvision vgg16.features: (index of each conv, its channels); a 2x2 max
# pool sits before convs 5, 10, 17 and 24, and LPIPS taps the relus after
# convs 2, 7, 14, 21 and 28 (relu1_2, 2_2, 3_3, 4_3, 5_3)
_VGG_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
              (14, 256), (17, 512), (19, 512), (21, 512), (24, 512),
              (26, 512), (28, 512))
_VGG_TAPS = (2, 7, 14, 21, 28)
_VGG_POOL_BEFORE = (5, 10, 17, 24)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


class VGG16Features(nn.Module):
    """The torchvision VGG16 feature trunk up to relu5_3, as the Sequential
    `features` with torchvision's indices (conv `features.N`); returns the
    five relu taps of LPIPS. Input (B, 3, H, W), already LPIPS-scaled."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for idx, ch in _VGG_CONVS:
            if idx in _VGG_POOL_BEFORE:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [nn.Conv2d(c_in, ch, 3, padding=1), nn.ReLU()]
            c_in = ch
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor):
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i - 1 in _VGG_TAPS:
                feats.append(x)
        return feats


class VGGLPIPS(nn.Module):
    """LPIPS(net="vgg") (pip `lpips`, consumed at `nsr/losses/builder.py:
    530`): the scaling layer, the VGG taps, channel unit-normalisation
    (x · rsqrt(Σx² + 1e-10)), squared difference, the bias-free 1x1 convs
    `lins.k`, the mean over (C, H, W), summed over the taps, then the mean
    over the batch. Inputs (B, 3, H, W) in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False)
                                  for c in LPIPS_CHANNELS)
        self.register_buffer(
            "shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1),
            persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.net((a - self.shift) / self.scale)
        fb = self.net((b - self.shift) / self.scale)
        total = 0.0
        for lin, xa, xb in zip(self.lins, fa, fb):
            na = xa * torch.rsqrt((xa * xa).sum(1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt((xb * xb).sum(1, keepdim=True) + 1e-10)
            total = total + lin((na - nb) ** 2).mean(dim=(1, 2, 3))
        return total.mean()


def lpips_vgg(a: torch.Tensor, b: torch.Tensor, net: VGGLPIPS
              ) -> torch.Tensor:
    """a, b (B, 3, H, W) in [0, 1]."""
    return net(a * 2 - 1, b * 2 - 1)


# ----------------------------------------------------------------- ssim

def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over (B, C, H, W) images in [0, 1]."""
    r = torch.arange(window, dtype=torch.float32, device=a.device) \
        - (window - 1) / 2
    g = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    k2d = torch.outer(g, g)[None, None]

    def blur(x):
        B, C, H, W = x.shape
        return F.conv2d(x.reshape(B * C, 1, H, W), k2d,
                        padding=window // 2).reshape(B, C, H, W)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = blur(a), blur(b)
    # blur(x²) − µ² can go slightly negative in fp32 on flat regions
    va = torch.clamp(blur(a * a) - mu_a ** 2, min=0.0)
    vb = torch.clamp(blur(b * b) - mu_b ** 2, min=0.0)
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return s.mean()


# ------------------------------------------------------------ geometry

def depth_loss_scale_invariant(pred: torch.Tensor, gt: torch.Tensor,
                               mask: torch.Tensor, sums: bool = False):
    """Scale-invariant depth (`E3DGELossClass`, line 412): per batch
    element, the closed-form scale and shift on the masked pixels, then
    L1. sums: return the masked L1 sum and the mask sum whose ratio (the
    latter clamped to at least 1) is the loss, for a caller that sums them
    over a batch split across ranks."""
    B = pred.shape[0]
    p = pred.reshape(B, -1)
    g = gt.reshape(B, -1)
    m = mask.reshape(B, -1).to(p.dtype)
    n = torch.clamp(m.sum(-1), min=1.0)
    mp = (p * m).sum(-1) / n
    mg = (g * m).sum(-1) / n
    var_p = ((p - mp[:, None]) ** 2 * m).sum(-1) / n
    cov = ((p - mp[:, None]) * (g - mg[:, None]) * m).sum(-1) / n
    s = cov / (var_p + 1e-8)
    t = mg - s * mp
    aligned = s[:, None] * p + t[:, None]
    num, den = ((aligned - g).abs() * m).sum(), m.sum()
    return (num, den) if sums else num / torch.clamp(den, min=1.0)


def normal_consistency_loss(rend_normal: torch.Tensor,
                            surf_normal: torch.Tensor,
                            alpha: torch.Tensor) -> torch.Tensor:
    """2DGS normal regulariser: (1 − n·n̂)·alpha, mean
    (`nsr/train_nv_util.py:2158-2166`); (B, V, 3, H, W) normals."""
    rn = rend_normal * torch.rsqrt(
        (rend_normal ** 2).sum(2, keepdim=True) + 1e-12)
    sn = surf_normal * torch.rsqrt(
        (surf_normal ** 2).sum(2, keepdim=True) + 1e-12)
    dot = (rn * sn).sum(2, keepdim=True)
    return ((1.0 - dot) * alpha).mean()


def depth_to_normal(depth: torch.Tensor, cam_view: torch.Tensor,
                    tanfov) -> torch.Tensor:
    """Backproject a (B, V, 1, H, W) depth to world points; the cross
    product of their finite differences is the pseudo surface normal
    (B, V, 3, H, W) (`utils/point_utils.py:11,65`)."""
    B, V, _, H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2 - 1
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    tf = torch.as_tensor(tanfov, dtype=torch.float32, device=dev) \
        .expand(B, V)[..., None, None]
    cv = cam_view.float()

    def e(i, j):
        return cv[:, :, i, j, None, None]

    z = depth[:, :, 0]
    # world point: (p_view − t) @ R.T with the row-vector world→view
    # rotation R = cv[:3, :3] (its inverse is its transpose)
    pv = (gx * tf * z - e(3, 0), gy * tf * z - e(3, 1), z - e(3, 2))
    pw = [pv[0] * e(j, 0) + pv[1] * e(j, 1) + pv[2] * e(j, 2)
          for j in range(3)]

    def diff_w(p):      # ∂/∂x, zero at the right edge
        return torch.diff(p, dim=-1, append=p[..., -1:])

    def diff_h(p):
        return torch.diff(p, dim=-2, append=p[..., -1:, :])

    dx = [diff_w(p) for p in pw]
    dy = [diff_h(p) for p in pw]
    n0 = dx[1] * dy[2] - dx[2] * dy[1]
    n1 = dx[2] * dy[0] - dx[0] * dy[2]
    n2 = dx[0] * dy[1] - dx[1] * dy[0]
    inv = torch.rsqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-12)
    return torch.stack([n0 * inv, n1 * inv, n2 * inv], dim=2)


# --------------------------------------------------------- regularisers

def scale_reg(gaussians: torch.Tensor, max_scale: float = 0.05
              ) -> torch.Tensor:
    """Penalise splats growing beyond max_scale
    (`nsr/train_nv_util.py:2143`)."""
    return F.relu(gaussians[..., 4:6] - max_scale).mean()


def opacity_reg(gaussians: torch.Tensor) -> torch.Tensor:
    """Push opacities towards {0, 1} (`nsr/train_nv_util.py:2149-2155`)."""
    o = torch.clamp(gaussians[..., 3], 1e-4, 1 - 1e-4)
    return -(o * torch.log(o) + (1 - o) * torch.log(1 - o)).mean()


# ------------------------------------------------------------------ GAN

class PatchDiscriminator(nn.Module):
    """PatchGAN `NLayerDiscriminator` (`nsr/losses/disc.py`) as the JAX
    package builds it: a 4x4 stride-2 conv and LeakyReLU(0.2), then
    `layers` bias-free 4x4 convs (stride 2, the last stride 1) each with
    GroupNorm(32, eps 1e-6) and LeakyReLU(0.2), then a 4x4 conv to one
    logit per patch. Every conv pads as flax's "SAME" (`SameConv2d`: at
    stride 1 a 4x4 kernel pads 1 before and 2 after), which torch's
    `padding=1` does not. Input (B, 3, H, W); `convs.i` and `norms.i` are
    flax's `Conv_i` and `GroupNorm_i`."""

    def __init__(self, ch: int = 64, layers: int = 3):
        super().__init__()
        convs = [SameConv2d(3, ch, 4, stride=2)]
        norms = []
        c_in = ch
        for i in range(1, layers + 1):
            c = min(ch * 2 ** i, 512)
            convs.append(SameConv2d(c_in, c, 4, stride=2 if i < layers
                                    else 1, bias=False))
            norms.append(nn.GroupNorm(32, c, eps=1e-6))
            c_in = c
        convs.append(SameConv2d(c_in, 1, 4))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.convs[0](x), 0.2)
        for conv, norm in zip(self.convs[1:-1], self.norms):
            h = F.leaky_relu(norm(conv(h)), 0.2)
        return self.convs[-1](h)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor
                 ) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def hinge_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -logits_fake.mean()


def kl_coeff_schedule(step: int, target: float = 1e-5,
                      anneal_steps: int = 5000) -> float:
    """Linear KL annealing (the reference's `nsr/losses`, 192-199)."""
    return target * min(max(step / anneal_steps, 0.0), 1.0)
