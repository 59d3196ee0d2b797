"""Shared building blocks (port of `gaussiananything_tpu/models/layers.py`).

Parameter names follow the reference's torch modules, so the state dicts of
the release checkpoints map onto them name for name:

  * `Attention`: packed `qkv` (+ `q_norm`/`k_norm`), `proj` (vit/xformers
    `Attention`, DINOv2's attention, the DiT self-attention);
  * `CrossAttention`: separate `to_q`/`to_k`/`to_v`, `to_out.0`
    (ldm `MemoryEfficientCrossAttention`);
  * `Mlp`: `fc1`/`fc2` (timm; xformers' FusedMLP layout is converted to it
    by `gaussiananything_tpu/utils/param_io._norm_fused_mlp`);
  * `TransformerBlock`: `0.norm`, `0.fn.*`, `1.norm`, `1.fn.*` (one layer of
    `nsr/srt/layers.py:146` Transformer);
  * `ResBlock`: `norm1`, `conv1`, `norm2`, `conv2`, `nin_shortcut` (ldm
    `ResnetBlock`). Convolutions run NCHW; the JAX package's NHWC kernels
    are transposed by `utils/param_io.from_jax_params`.

Attention is the JAX package's XLA path (`layers.py:32-68`): matmul, fp32
softmax, matmul. Its no-grad fp32 calls on the card under the TF32 policy
go to one fused kernel (`ops/attention.py`); every other call is plain
PyTorch, computed in query blocks once the score matrix would exceed 4096²
elements. In the same way a no-grad fp32 `RMSNorm` on the card, the q and k
norms of an attention, and the DiT blocks' residual + norm + modulation
(`norm_rows`) are one launch of the row-norm kernel (`ops/rownorm.py`);
every other call computes the same expressions in PyTorch.

`dtype` is the compute dtype, the JAX modules' `dtype`: mixed precision
as `config.VAEModelConfig.compute_dtype` defines it. The parameters are
fp32 whatever it is. `Linear`, `Conv2d` and `SameConv2d` cast their
input, weight and bias to it at the point of use (flax `nn.Dense(dtype=
...)`'s promotion), so under bfloat16 the products run in bf16 and
autograd returns fp32 gradients to the fp32 parameters. `LayerNorm`,
`RMSNorm` and `GroupNorm32` compute and return fp32, as the JAX package
pins every norm with `dtype=jnp.float32`. Attention scores and the softmax
are fp32; the probabilities are cast back to the values' dtype for the
second product (`jax.nn.dot_product_attention`). A module whose
parameters were themselves cast to bf16 (the sampling-only cast of
`cli/sample.py --bf16`, as the JAX CLI's) computes the same way, its
norms reading the rounded weights.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gaussiananything_tpu_torch.ops import attention as attention_ops
from gaussiananything_tpu_torch.ops import rownorm as rownorm_ops

_SCORES_BLOCK_THRESHOLD = 4096 * 4096
_QUERY_BLOCK = 2048


def approx_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (flax's `nn.gelu` default)."""
    return F.gelu(x, approximate="tanh")


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU (`sd_encoder.exact_gelu`; torch's `nn.GELU` default)."""
    return F.gelu(x)


# q (B,H,T,D), k/v (B,H,S,D) → (B,H,T,D): the plain version
_attend = attention_ops.attention_plain


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact softmax attention, q (B,T,H,D), k/v (B,S,H,D) → (B,T,H,D);
    `bias` is an additive score mask (1, 1, T, S), as a causal mask.

    A no-grad fp32 call on the card under the TF32 policy, of head dim 64
    and at least 64 queries and keys, with no bias, is one launch of the
    fused kernel (`ops/attention.attention`; the rule is
    `ops/attention.plain_reasons`). Every other call takes the plain
    version below: training, bf16, the "ieee" policy, a mask, small groups.

    Above 4096² scores per (batch, head) the queries run in blocks of 2048,
    which bounds the score memory and changes no value; under autograd
    each block is checkpointed (its scores are recomputed in the backward,
    as the JAX package's `_blocked_attention` does), or the 16k-token
    joint-view attention of the 512² encoder would keep 8 GB of
    probabilities per batch element.
    """
    if not attention_ops.plain_reasons(q, k, v, bias):
        return attention_ops.attention(q, k, v)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    T, S = q.shape[2], k.shape[2]
    if bias is not None:
        if T * S > _SCORES_BLOCK_THRESHOLD:
            raise ValueError("a score bias is taken only below the block "
                             "threshold")
        return _attend(q, k, v, bias).transpose(1, 2)
    if T * S > _SCORES_BLOCK_THRESHOLD:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            def block(qb):
                return checkpoint(_attend, qb, k, v, use_reentrant=False)
        else:
            def block(qb):
                return _attend(qb, k, v)
        out = torch.cat([block(q[:, :, i:i + _QUERY_BLOCK])
                         for i in range(0, T, _QUERY_BLOCK)], dim=2)
    else:
        out = _attend(q, k, v)
    return out.transpose(1, 2)


def norm_rows(x: torch.Tensor, norm: Optional["RMSNorm"] = None,
              y: Optional[torch.Tensor] = None,
              gate: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None):
    """(x', h): x' = x + gate·y (or x + y, or x), h = modulate(norm(x'),
    shift, scale) (or norm(x'), or None without a norm); gate, shift and
    scale per batch, (B, D). A call that `ops/rownorm.plain_reasons`
    passes is one launch of the row-norm kernel; every other call computes
    these expressions in PyTorch (`rownorm_plain`), each norm on a CUDA
    tensor counted in `rownorm_ops.plain` by its reasons."""
    w = None if norm is None else norm.weight
    eps = 1e-5 if norm is None else norm.eps
    why = rownorm_ops.plain_reasons(x, y, gate, w, shift, scale)
    if not why:
        return rownorm_ops.rownorm(x, y, gate, w, eps, shift, scale)
    if norm is not None and x.device.type == "cuda":
        rownorm_ops.plain["+".join(why)] += 1
    return rownorm_ops.rownorm_plain(x, y, gate, w, eps, shift, scale)


def qk_norms(q: torch.Tensor, k: torch.Tensor, q_norm: "RMSNorm",
             k_norm: "RMSNorm"):
    """(q_norm(q), k_norm(k)) over the heads' last dim: one launch for both
    where the kernel takes each (`rownorm_pair`), else each on its own."""
    if not rownorm_ops.plain_reasons(q, weight=q_norm.weight, k=k,
                                     k_weight=k_norm.weight):
        return rownorm_ops.rownorm_pair(q, q_norm.weight, q_norm.eps,
                                        k, k_norm.weight, k_norm.eps)
    return q_norm(q), k_norm(k)


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · weight (`dit/norm.py:12`, eps 1e-5);
    fp32 whatever the dtype of x and of the weight. A no-grad fp32 call on
    the card is one launch of the row-norm kernel (`norm_rows`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_rows(x, self)[1]


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` computed in fp32 whatever the dtype of x and of the
    weights (flax `nn.LayerNorm(dtype=jnp.float32)`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps)


def _at(t: Optional[torch.Tensor], dtype: torch.dtype
        ) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """`nn.Linear` with fp32 parameters that computes in `dtype`: input,
    weight and bias are cast to it at use (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        _at(self.bias, self.dtype))


class Mlp(nn.Module):
    def __init__(self, d_in: int, hidden: int, d_out: Optional[int] = None,
                 act: Callable = approx_gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.fc1 = Linear(d_in, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, d_out or d_in, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Attention(nn.Module):
    """Self-attention with a packed qkv projection and optional head-dim
    RMSNorm on q and k (the JAX `Attention` with `context=None`)."""

    def __init__(self, dim: int, heads: int, qk_norm: bool = False,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        dh = dim // heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.q_norm = RMSNorm(dh) if qk_norm else None
        self.k_norm = RMSNorm(dh) if qk_norm else None
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        qkv = self.qkv(x).reshape(B, T, 3, self.heads, D // self.heads)
        q, k, v = qkv.unbind(2)
        if self.q_norm is not None:
            # the normed q, k go back to the compute dtype (JAX `Attention`)
            q, k = qk_norms(q, k, self.q_norm, self.k_norm)
            q, k = q.to(v.dtype), k.to(v.dtype)
        o = dot_attention(q, k, v).reshape(B, T, D)
        return self.proj(o)


class CrossAttention(nn.Module):
    """Attention of `x` over `context` with separate q/k/v projections
    (the JAX `Attention` with a context)."""

    def __init__(self, dim: int, context_dim: int, heads: int,
                 dim_head: Optional[int] = None, qk_norm: bool = False,
                 qkv_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        dh = dim_head or dim // heads
        inner = dh * heads
        self.to_q = Linear(dim, inner, bias=qkv_bias, dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=qkv_bias, dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=qkv_bias, dtype=dtype)
        self.q_norm = RMSNorm(dh) if qk_norm else None
        self.k_norm = RMSNorm(dh) if qk_norm else None
        self.to_out = nn.Sequential(Linear(inner, dim, dtype=dtype))

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        def split(t):
            return t.reshape(t.shape[:-1] + (self.heads, -1))

        q = split(self.to_q(x))
        k = split(self.to_k(context))
        v = split(self.to_v(context))
        if self.q_norm is not None:
            q, k = qk_norms(q, k, self.q_norm, self.k_norm)
            q, k = q.to(v.dtype), k.to(v.dtype)
        o = dot_attention(q, k, v)
        return self.to_out(o.reshape(o.shape[:-2] + (-1,)))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, eps: float = 1e-5):
        super().__init__()
        self.norm = LayerNorm(dim, eps=eps)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class TransformerBlock(nn.ModuleList):
    """Pre-norm self-attention block (`nsr/srt/layers.py:146`):
    x + attn(LN(x)), then + mlp(LN(x)); LayerNorm eps 1e-5."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, act: Callable = approx_gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__([
            PreNorm(dim, Attention(dim, heads, qk_norm=qk_norm,
                                   dtype=dtype)),
            PreNorm(dim, Mlp(dim, int(dim * mlp_ratio), dim, act=act,
                             dtype=dtype)),
        ])
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self[0](x)
        return x + self[1](x)


class Transformer(nn.Module):
    """A stack of `TransformerBlock`s under `layers.{i}`."""

    def __init__(self, dim: int, depth: int, heads: int, **kw):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerBlock(dim, heads, **kw) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention + MLP (`nsr/srt/encoder.py:475-494`): the
    queries attend to LN(kv tokens) with q/k RMSNorm and biased q/k/v."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 qk_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm_q = LayerNorm(dim, eps=1e-5)
        self.norm_kv = LayerNorm(dim, eps=1e-5)
        self.attn = CrossAttention(dim, dim, heads, qk_norm=qk_norm,
                                   qkv_bias=True, dtype=dtype)
        self.norm_mlp = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, q_tokens: torch.Tensor, kv_tokens: torch.Tensor
                ) -> torch.Tensor:
        q_tokens = q_tokens + self.attn(self.norm_q(q_tokens),
                                        self.norm_kv(kv_tokens))
        return q_tokens + self.mlp(self.norm_mlp(q_tokens))


def fourier_embed(x: torch.Tensor, multires: int = 10,
                  include_input: bool = True) -> torch.Tensor:
    """NeRF encoding [x, sin(x·2⁰), cos(x·2⁰), sin(x·2¹), …]
    (`vit/vit_triplane.py:187-230`)."""
    freqs = 2.0 ** torch.arange(multires, dtype=torch.float32,
                                device=x.device)
    xb = x[..., None, :] * freqs[:, None]               # (..., L, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    enc = enc.reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, enc], dim=-1) if include_input else enc


class XYZPosEmbed(nn.Module):
    """Fourier-encode xyz, then a linear projection (`xyz_projection`)."""

    def __init__(self, dim: int, multires: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.multires = multires
        self.dtype = dtype
        self.xyz_projection = Linear(3 * (2 * multires + 1), dim,
                                     dtype=dtype)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.xyz_projection(fourier_embed(xyz.float(), self.multires))


class TimestepEmbedder(nn.Module):
    """Sinusoidal (cos first, 256 frequencies) embedding + 2-layer SiLU MLP
    (`dit/dit_models_xformers.py:88`)."""

    def __init__(self, hidden: int, freq_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freq_dim = freq_dim
        self.dtype = dtype
        self.mlp = nn.Sequential(Linear(freq_dim, hidden, dtype=dtype),
                                 nn.SiLU(), Linear(hidden, hidden,
                                                   dtype=dtype))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.freq_dim // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[..., None] * freqs
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], -1))


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` with fp32 parameters that computes in `dtype` (flax
    `nn.Conv(dtype=...)`), as `Linear` does."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, kernel, stride=stride,
                         padding=padding, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  _at(self.bias, self.dtype))


class SameConv2d(Conv2d):
    """Conv2d with flax's "SAME" padding on NCHW input: the output is
    ceil(size / stride), the total padding split with the extra pixel at
    the bottom/right (torch's own padding is symmetric, which differs for a
    stride-2 kernel on an even size)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, kernel, stride=stride, bias=bias,
                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):         # F.pad: W first
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x.to(self.dtype), pads))


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over min(32, C) groups, fp32, eps 1e-6 (flax's default,
    which the JAX package's `GroupNorm32` keeps)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(min(groups, channels), channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class ResBlock(nn.Module):
    """SD-encoder residual conv block on NCHW: GN + SiLU + 3x3 conv, twice,
    with a 1x1 shortcut conv when the channels change. Serves both the JAX
    package's `ResBlock` and `SDResnetBlock` (`ldm/modules/
    diffusionmodules/model.py:469` with temb_channels=0, dropout=0), whose
    parameter names it takes."""

    def __init__(self, c_in: int, c_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm32(c_in)
        self.conv1 = SameConv2d(c_in, c_out, 3, dtype=dtype)
        self.norm2 = GroupNorm32(c_out)
        self.conv2 = SameConv2d(c_out, c_out, 3, dtype=dtype)
        self.nin_shortcut = SameConv2d(c_in, c_out, 1, dtype=dtype) \
            if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    return x * (1 + scale) + shift


def get_2d_sincos_pos_embed(dim: int, grid: int) -> np.ndarray:
    """The DiT 2D sin-cos position table, (grid², dim) fp32
    (`gaussiananything_tpu/models/layers.py:207`)."""
    def _1d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    emb = np.concatenate(
        [_1d(dim // 2, gy.reshape(-1)), _1d(dim // 2, gx.reshape(-1))], axis=1)
    return emb.astype(np.float32)
