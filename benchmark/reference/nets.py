"""The plain reference of the release networks, a frozen copy kept with the
benchmark so that it reads the same whatever the program becomes.

DINOv2 ViT-L/14 with registers (the image conditioner), the CLAY-L point
DiT (stage 1 and stage 2), the release VAE decoder (DiT2, the surfel head,
the upsamplers), and, for training, the VAE encoder. The equations follow
the published models (`dit/dit_models_xformers.py`, `dit/dit_decoder.py`,
`vit/vit_triplane.py` of GaussianAnything; DINOv2's torch-hub model); the
parameter names are the released state dicts', which the program's modules
also use, so one seeded state dict loads into both.

Products run in `precision.POLICY.net` (fp32; bf16 in the control);
norms, attention scores and softmax, adaLN sums and the activated
gaussians are fp32, as the configuration states.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import precision
from benchmark.reference.precision import POLICY

POS_BOUND = 0.45
SCALE_GAIN = 0.45 * 0.01 / math.log(2.0)


_net = precision.net

# Under autograd the blocks below recompute their activations in the
# backward (memory only: the values are the same). The training check
# turns it on: its IEEE fp32 step at the timed batch would not fit else.
CHECKPOINT = {"on": False}


def _ckpt(fn, *args):
    if CHECKPOINT["on"] and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_net(x), _net(self.weight), _net(self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(_net(x), _net(self.weight),
                                  _net(self.bias))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * self.weight.float()


def exact_gelu(x):
    return F.gelu(x)


def attend(q, k, v):
    """q (B,T,H,D), k/v (B,S,H,D): fp32 scores and softmax, the
    probabilities cast to the values' dtype; query blocks of 2048 above
    4096² scores (memory only)."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])

    def block(qb):
        s = torch.matmul(qb.float(), k.float().transpose(-1, -2)) * scale
        return torch.matmul(torch.softmax(s, -1).to(v.dtype), v)

    T, S = q.shape[2], k.shape[2]
    if T * S > 4096 * 4096:
        out = torch.cat([_ckpt(block, q[:, :, i:i + 2048])
                         for i in range(0, T, 2048)], dim=2)
    else:
        out = block(q)
    return out.transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, d_in, hidden, d_out=None, act=None):
        super().__init__()
        self.act = act or (lambda x: F.gelu(x, approximate="tanh"))
        self.fc1 = Linear(d_in, hidden)
        self.fc2 = Linear(hidden, d_out or d_in)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim, heads, qk_norm=False, qkv_bias=True):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.q_norm = RMSNorm(dim // heads) if qk_norm else None
        self.k_norm = RMSNorm(dim // heads) if qk_norm else None
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, T, D = x.shape
        q, k, v = self.qkv(x).reshape(B, T, 3, self.heads, -1).unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q).to(v.dtype), self.k_norm(k).to(v.dtype)
        return self.proj(attend(q, k, v).reshape(B, T, D))


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, heads, dim_head, qk_norm=True,
                 qkv_bias=False):
        super().__init__()
        self.heads = heads
        inner = dim_head * heads
        self.to_q = Linear(dim, inner, bias=qkv_bias)
        self.to_k = Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_v = Linear(ctx_dim, inner, bias=qkv_bias)
        self.q_norm = RMSNorm(dim_head) if qk_norm else None
        self.k_norm = RMSNorm(dim_head) if qk_norm else None
        self.to_out = nn.Sequential(Linear(inner, dim))

    def forward(self, x, ctx):
        def split(t):
            return t.reshape(t.shape[:-1] + (self.heads, -1))
        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), \
            split(self.to_v(ctx))
        if self.q_norm is not None:
            q, k = self.q_norm(q).to(v.dtype), self.k_norm(k).to(v.dtype)
        o = attend(q, k, v)
        return self.to_out(o.reshape(o.shape[:-2] + (-1,)))


def modulate(x, shift, scale):
    return x * (1 + scale) + shift


# --------------------------------------------------------------- DINOv2


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class DinoBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, dim, act=exact_gelu)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch, width):
        super().__init__()
        self.proj = Conv2d(3, width, patch, stride=patch)


class Dinov2(nn.Module):
    def __init__(self, patch, width, depth, heads, num_registers, img_size):
        super().__init__()
        self.patch, self.num_registers = patch, num_registers
        n0 = (img_size // patch) ** 2
        self.patch_embed = PatchEmbed(patch, width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n0, width))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, num_registers, width))
        self.blocks = nn.ModuleList([DinoBlock(width, heads)
                                     for _ in range(depth)])
        self.norm = LayerNorm(width, eps=1e-6)

    def forward(self, images):
        """images (B,3,H,W), imagenet-normalised, at the native size."""
        B = images.shape[0]
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, -1, -1).to(x.dtype), x], 1)
        x = x + self.pos_embed.to(x.dtype)
        x = torch.cat([x[:, :1],
                       self.register_tokens.expand(B, -1, -1).to(x.dtype),
                       x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1 + self.num_registers:], x[:, 0]


class ImageConditioner(nn.Module):
    """DINOv2 on the imagenet-normalised image: (patch tokens, cls)."""

    def __init__(self, c):
        super().__init__()
        self.vit = Dinov2(c["patch"], c["width"], c["depth"], c["heads"],
                          c["num_registers"], c["img_size"])

    def forward(self, images):
        mean = torch.tensor((0.485, 0.456, 0.406), device=images.device)
        std = torch.tensor((0.229, 0.224, 0.225), device=images.device)
        x = (images.float() - mean[:, None, None]) / std[:, None, None]
        return self.vit(x)


# ------------------------------------------------------------ point DiT


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden, freq_dim=256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(Linear(freq_dim, hidden), nn.SiLU(),
                                 Linear(hidden, hidden))

    def forward(self, t):
        half = self.freq_dim // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[..., None] * freqs
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], -1))


def fourier_embed(x, multires=10):
    freqs = 2.0 ** torch.arange(multires, dtype=torch.float32,
                                device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], -1)
    return torch.cat([x, enc.reshape(x.shape[:-1] + (-1,))], -1)


class XYZPosEmbed(nn.Module):
    def __init__(self, dim, multires=10):
        super().__init__()
        self.multires = multires
        self.xyz_projection = Linear(3 * (2 * multires + 1), dim)

    def forward(self, xyz):
        return self.xyz_projection(fourier_embed(xyz.float(), self.multires))


class ClayBlock(nn.Module):
    """Cross-attention to the image tokens, then adaLN-gated qk-normed
    self-attention and an exact-GELU MLP."""

    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.norm1 = RMSNorm(dim)
        self.norm2 = RMSNorm(dim)
        self.attn = Attention(dim, heads, qk_norm=True)
        self.mlp = Mlp(dim, 4 * dim, dim, act=exact_gelu)
        self.scale_shift_table = nn.Parameter(torch.zeros(6, dim))
        self.cross_attn_dino = CrossAttention(dim, ctx_dim, heads,
                                              dim // heads)
        self.prenorm_ca_dino = RMSNorm(dim)

    def forward(self, x, ctx, ada):
        mod = ada + self.scale_shift_table[None]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (mod[:, i, None] for i in range(6))
        x = x + self.cross_attn_dino(self.prenorm_ca_dino(x), ctx)
        x = x + g_a * self.attn(modulate(self.norm1(x), sh_a, sc_a))
        return x + g_m * self.mlp(modulate(self.norm2(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    def __init__(self, dim, out_ch):
        super().__init__()
        self.norm_final = LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.linear = Linear(dim, out_ch)
        self.scale_shift_table = nn.Parameter(torch.zeros(2, dim))

    def forward(self, x, c):
        t2 = self.scale_shift_table[None] + c[:, None, :]
        return self.linear(modulate(self.norm_final(x), t2[:, 0, None],
                                    t2[:, 1, None]))


class PointDiT(nn.Module):
    """The CLAY-L flow DiT: raw t ∈ [0,1] embedded, plus the pooled
    image vector through LN + Linear, drives one shared adaLN."""

    def __init__(self, c):
        super().__init__()
        w = c["width"]
        self.width = w
        self.x_embedder = Mlp(c["in_channels"], w, w)
        self.t_embedder = TimestepEmbedder(w)
        self.pooled_vec_embedder = nn.Sequential(
            LayerNorm(c["vector_dim"], eps=1e-5), Linear(c["vector_dim"], w))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(w, 6 * w))
        self.blocks = nn.ModuleList([ClayBlock(w, c["heads"], c["cond_dim"])
                                     for _ in range(c["depth"])])
        self.final_layer = FinalLayer(w, c["in_channels"])
        self.xyz_pos_embed = XYZPosEmbed(w) if c["in_channels"] != 3 \
            else None

    def forward(self, x, t, tokens, vector, xyz=None):
        h = self.x_embedder(x.float())
        if self.xyz_pos_embed is not None:
            h = h + self.xyz_pos_embed(xyz)
        c = self.t_embedder(t) + self.pooled_vec_embedder(vector)
        ada = self.adaLN_modulation(c).reshape(c.shape[0], 6, self.width)
        ctx = tokens.to(POLICY.net)
        for blk in self.blocks:
            h = blk(h, ctx, ada)
        return self.final_layer(h, c).float()


# ----------------------------------------------------------- VAE decoder


class DiTBlock2(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.norm2 = LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.attn = Attention(dim, heads, qk_norm=True)
        self.mlp = Mlp(dim, 4 * dim, dim, act=exact_gelu)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 6 * dim))

    def forward(self, x, c):
        return _ckpt(self._forward, x, c)

    def _forward(self, x, c):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = \
            self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + g_a * self.attn(modulate(self.norm1(x), sh_a, sc_a))
        return x + g_m * self.mlp(modulate(self.norm2(x), sh_m, sc_m))


class DiT2(nn.Module):
    """Even blocks attend within each third of the tokens, odd blocks
    over all of them."""

    def __init__(self, num_tokens, width, depth, heads, plane_n=3):
        super().__init__()
        self.plane_n = plane_n
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, width))
        self.blocks = nn.ModuleList([DiTBlock2(width, heads)
                                     for _ in range(depth)])

    def forward(self, c):
        B, K, D = c.shape
        n = self.plane_n
        x = self.pos_embed.expand(B, -1, -1).to(POLICY.net)
        for i, blk in enumerate(self.blocks):
            if i % 2 == 0:
                x = blk(x.reshape(B * n, K // n, D),
                        c.reshape(B * n, K // n, D)).reshape(B, K, D)
            else:
                x = blk(x, c)
        return x


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class TransformerBlock(nn.ModuleList):
    def __init__(self, dim, heads, qk=True):
        super().__init__([
            PreNorm(dim, Attention(dim, heads, qk_norm=qk)),
            PreNorm(dim, Mlp(dim, 4 * dim, dim, act=exact_gelu))])

    def forward(self, x):
        return _ckpt(self._forward, x)

    def _forward(self, x):
        x = x + self[0](x)
        return x + self[1](x)


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads):
        super().__init__()
        self.layers = nn.ModuleList([TransformerBlock(dim, heads)
                                     for _ in range(depth)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Upsampler(nn.Module):
    """Each parent's feature with f learned queries through a small
    transformer; a pre-norm linear head gives the children's residual."""

    def __init__(self, dim, factor, depth):
        super().__init__()
        self.factor = factor
        self.latent_embedding = nn.Parameter(torch.zeros(1, factor, dim))
        self.transformer = Transformer(dim, depth, dim // 64)
        self.gaussian_residual_pred = PreNorm(dim, Linear(dim, 13))

    def forward(self, feat, raw):
        B, N, D = feat.shape
        f = self.factor
        q = self.latent_embedding.expand(B * N, -1, -1).to(POLICY.net)
        grp = torch.cat([feat.reshape(B * N, 1, D).to(POLICY.net), q], 1)
        child = self.transformer(grp)[:, 1:].reshape(B, N * f, D)
        residual = self.gaussian_residual_pred(child)
        return child, torch.repeat_interleave(raw, f, 1) + residual, \
            residual


class SurfelHead(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.gaussian_pred = nn.Sequential(nn.SiLU(), Linear(width, 13))

    def forward(self, x):
        return self.gaussian_pred(x)


def activate_at(pos, raw):
    raw = raw.float()
    rot = raw[..., 6:10]
    rot = rot * torch.rsqrt((rot * rot).sum(-1, keepdim=True) + 1e-16)
    return torch.cat([pos.float(), torch.sigmoid(raw[..., 3:4]),
                      F.softplus(raw[..., 4:6]) * SCALE_GAIN, rot,
                      0.5 * torch.tanh(raw[..., 10:13]) + 0.5], -1)


class VAEDecoder(nn.Module):
    """The release VAE's decode: latent → DiT2 → base surfels at the
    anchors → the upsamplers' LoDs (activated 13-channel gaussians)."""

    def __init__(self, c, with_encoder: bool = False):
        super().__init__()
        w, z = c["decoder_width"], c["z_channels"]
        self.skip_weight = c["skip_weight"]
        self.up_factors = tuple(c["up_factors"])
        sr = nn.ModuleDict({
            "post_quant_conv": Mlp(z, z, w),
            "conv_sr": SurfelHead(w),
        })
        if with_encoder:
            sr["quant_conv"] = Mlp(2 * z, 2 * z, 2 * z)
        for k, (f, d) in enumerate(zip(c["up_factors"], c["up_depths"])):
            sr[f"ada_CA_f4_{k + 1}"] = Upsampler(w, f, d)
        self.decoder = nn.ModuleDict({
            "vit_decoder": DiT2(c["latent_num"], w, c["decoder_depth"],
                                c["decoder_heads"]),
            "superresolution": sr})

    def decode(self, z, anchors) -> List[torch.Tensor]:
        sr = self.decoder["superresolution"]
        feat = self.decoder["vit_decoder"](sr["post_quant_conv"](z.float()))
        raw = sr["conv_sr"](feat)
        half = POS_BOUND * 0.5
        pos = anchors.float() + torch.tanh(raw[..., 0:3].float()) \
            * (half * self.skip_weight)
        lods = [activate_at(pos, raw)]
        parent = lods[0][..., 0:3]
        for k, f in enumerate(self.up_factors):
            feat, raw, res = sr[f"ada_CA_f4_{k + 1}"](feat, raw)
            pos = torch.repeat_interleave(parent, f, 1) \
                + torch.tanh(res[..., 0:3].float()) * half
            lods.append(activate_at(pos, raw))
            parent = lods[-1][..., 0:3]
        return lods


def build(kind: str, c: dict) -> nn.Module:
    return {"conditioner": ImageConditioner, "dit": PointDiT,
            "vae_decoder": VAEDecoder, "vae": VAE}[kind](c)


def cfg_guided(dit, tokens, vector, scale: float, xyz=None):
    """Classifier-free guidance: one batch-doubled call, zero conditioning
    for the unconditional half."""
    ctx = torch.cat([tokens, torch.zeros_like(tokens)])
    vec = torch.cat([vector, torch.zeros_like(vector)])
    xyz2 = None if xyz is None else torch.cat([xyz, xyz])

    def guided(x, t):
        v = dit(torch.cat([x, x]), torch.cat([t, t]), ctx, vec, xyz=xyz2)
        v_c, v_u = v.chunk(2)
        return v_u + scale * (v_c - v_u)

    return guided



# ------------------------------------------------------------ VAE encoder


class SameConv2d(Conv2d):
    """A convolution with flax's "SAME" padding (the extra pixel at the
    bottom and right)."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(_net(x), pads))


class GroupNorm32(nn.GroupNorm):
    def __init__(self, channels, groups=32):
        super().__init__(min(groups, channels), channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class ResBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm1 = GroupNorm32(c_in)
        self.conv1 = SameConv2d(c_in, c_out, 3)
        self.norm2 = GroupNorm32(c_out)
        self.conv2 = SameConv2d(c_out, c_out, 3)
        self.nin_shortcut = SameConv2d(c_in, c_out, 1) if c_in != c_out \
            else None

    def forward(self, x):
        return _ckpt(self._forward, x)

    def _forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(_net(x), (0, 1, 0, 1)))


class GEGLU(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = Linear(dim, 2 * dim * mult)
        self.net = nn.ModuleList([geglu, nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * exact_gelu(gate))


class MVMidAttention(nn.Module):
    """Joint attention over all views' tokens, then per view, then a
    GEGLU feed-forward, as a residual."""

    def __init__(self, ch, heads=8, dim_head=64):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(ch)
        self.proj_in = Linear(ch, inner)
        self.norm1 = LayerNorm(inner, eps=1e-5)
        self.attn1 = Attention(inner, heads, qkv_bias=False)
        self.norm2 = LayerNorm(inner, eps=1e-5)
        self.attn2 = Attention(inner, heads, qkv_bias=False)
        self.norm3 = LayerNorm(inner, eps=1e-5)
        self.ff = GEGLU(inner)
        self.proj_out = Linear(inner, ch)

    def forward(self, x):
        B, V, C, hh, ww = x.shape
        h = self.norm(x.reshape(B * V, C, hh, ww))
        t = self.proj_in(h.permute(0, 2, 3, 1)).reshape(B, V * hh * ww, -1)
        t = t + self.attn1(self.norm1(t))
        t = t.reshape(B * V, hh * ww, -1)
        t = t + self.attn2(self.norm2(t))
        t = t + self.ff(self.norm3(t))
        t = self.proj_out(t).reshape(B, V, hh, ww, C)
        return x + t.permute(0, 1, 4, 2, 3)


class SDTrunk(nn.Module):
    def __init__(self, in_ch=15, ch=64, ch_mult=(1, 2, 4, 4)):
        super().__init__()
        self.conv_in = Conv2d(in_ch, ch, 3, padding=1)
        self.down = nn.ModuleList()
        c = ch
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList([ResBlock(c, ch * mult)])
            c = ch * mult
            if i < len(ch_mult) - 1:
                level.downsample = Downsample(c)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResBlock(c, c)
        self.mid.attn_1 = MVMidAttention(c)
        self.mid.block_2 = ResBlock(c, c)
        self.norm_out = GroupNorm32(c)

    def forward(self, x):
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


def farthest_points(points, k):
    """Farthest point sampling from the first point, ties to the lowest
    index: (selected (B, k, 3), indices)."""
    B, n, _ = points.shape
    pts = points.detach().float()
    idx_n = torch.arange(n, device=points.device)

    def first_max(x):
        is_max = x == x.amax(-1, keepdim=True)
        return torch.where(is_max, idx_n, torch.full_like(idx_n, n)) \
            .amin(-1)

    rows = torch.arange(B, device=points.device)
    last = torch.zeros(B, dtype=torch.long, device=points.device)
    dists = torch.full((B, n), 1e10, device=points.device)
    idx = []
    for _ in range(k):
        idx.append(last)
        d = ((pts - pts[rows, last][:, None]) ** 2).sum(-1)
        dists = torch.minimum(dists, d)
        last = first_max(dists)
    idx = torch.stack(idx, 1)
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, 3)), idx


class Encoder(nn.Module):
    """The release point-cloud-structured encoder: the SD conv trunk over
    each 15-channel view, the tokens' Fourier xyz embedding, K farthest
    anchors cross-attending to the tokens, three transformer blocks, a
    pre-norm MLP to 2·z."""

    def __init__(self, latent_num, z_channels, width=256, heads=8,
                 srt_depth=3, downsample=8):
        super().__init__()
        self.latent_num, self.downsample = latent_num, downsample
        self.sd_trunk = SDTrunk()
        self.xyz_pos_embed = XYZPosEmbed(width)
        self.agg_ca = CrossAttention(width, width, heads, 64)
        self.srt = nn.ModuleList([TransformerBlock(width, heads, qk=True)
                                  for _ in range(srt_depth)])
        self.norm_out = LayerNorm(width, eps=1e-5)
        self.mlp_out = Mlp(width, width, 2 * z_channels)

    def forward(self, images, pcd):
        B = images.shape[0]
        feat = self.sd_trunk(images)
        c = feat.shape[2]
        tokens = feat.flatten(3).permute(0, 1, 3, 2).reshape(B, -1, c)
        f = self.downsample
        xyz = images[:, :, -3:, f // 2::f, f // 2::f]
        xyz = xyz.flatten(3).permute(0, 1, 3, 2).reshape(B, -1, 3)
        anchors, _ = farthest_points(pcd, self.latent_num)
        tokens = tokens + self.xyz_pos_embed(xyz)
        q = self.agg_ca(self.xyz_pos_embed(anchors), tokens)
        for block in self.srt:
            q = block(q)
        return self.mlp_out(self.norm_out(q)), anchors


class VAE(VAEDecoder):
    """The whole release VAE: encode, the KL bottleneck (log-variance
    soft-clamped to ±20), decode."""

    def __init__(self, c):
        super().__init__(c, with_encoder=True)
        self.latent_shape = (c["latent_num"], c["z_channels"])
        self.encoder = Encoder(c["latent_num"], c["z_channels"],
                               c["encoder_width"])

    def forward(self, images, pcd, noise):
        h, anchors = self.encoder(images, pcd)
        moments = self.decoder["superresolution"]["quant_conv"](h).float()
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = 20.0 * torch.tanh(logvar / 20.0)
        z = mean + torch.exp(0.5 * logvar) * noise
        kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar) \
            .flatten(1).sum(1)
        return {"lods": self.decode(z, anchors), "kl": kl, "z": z}
