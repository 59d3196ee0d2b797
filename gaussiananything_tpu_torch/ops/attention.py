"""Exact softmax attention: the plain version and the hand-written kernel.

  * `attention_plain(q, k, v, bias=None)`, q (B,H,T,D), k/v (B,H,S,D) →
    (B,H,T,D): matmul, scale by 1/√D, add `bias`, fp32 softmax, matmul, the
    JAX package's XLA attention (`gaussiananything_tpu/models/layers.py:
    32-68`). `models/layers._attend` is this function. It runs on any
    device and dtype, under autograd and under either matmul policy.
  * `attention(q, k, v)`, q (B,T,H,64), k/v (B,S,H,64) fp32 CUDA tensors →
    (B,T,H,64) fp32: one launch of `csrc/attention.cu`, a fused forward
    that keeps the scores on chip; its products are the plain version's
    under the TF32 policy.
  * `plain_reasons(q, k, v, bias)`: why `models/layers.dot_attention`
    keeps the plain version for a call, empty where it takes the kernel.

The kernel replaces no TPU kernel: the JAX package leaves attention to
XLA. It was added because the plain version writes each score matrix to
device memory and reads it back five times (written, scaled, softmaxed,
read), and in a release image-to-3D request that traffic was the largest
part of the DiT-L evaluations, which set the request's time. What bounds
it: an evaluation's attention (24 blocks, self 2 × 16 × 768², cross 2 × 16
× 768 × 1369) is 323 GFLOP in TF32, 0.65 ms at 495 TFLOP/s, against 1.45 GB
of q, k, v and o, 0.43 ms at 3.35 TB/s; the score traffic (30 GB) is gone.
The design notes are in the source.

`attention` counts its launches in `attention.launches` and opens the span
`ga.kernel.attn` around each (`utils/profiling.py`); a launch recorded into
a CUDA graph (`models/dit._ForwardGraphs`) counts and opens its span once,
at the capture, and its replays are counted by `ga.dit.replay`. The
library is built with the rasterizer's sources (`ops/rasterize_cuda.build`).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from gaussiananything_tpu_torch.ops import rasterize_cuda
from gaussiananything_tpu_torch.utils import profiling

HEAD_DIM = 64
# below a tile of 64 queries or keys the kernel's tiles are mostly padding:
# the upsamplers' 4-9-token groups stay plain
MIN_TOKENS = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,T,D), k/v (B,H,S,D) → (B,H,T,D); fp32 scores and softmax;
    `bias` (broadcast to (B,H,T,S)) is added to the scaled scores."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _aligned(t: torch.Tensor) -> bool:
    """Rows of the head dim contiguous, every other stride a whole number
    of 16-byte chunks, the base 16-byte aligned: what the kernel's 16-byte
    copies read."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 or n == 1
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def _same_frame(q, k, v) -> bool:
    return (q.dim() == k.dim() == v.dim() == 4 and k.shape == v.shape
            and q.shape[0] == k.shape[0] and q.shape[2] == k.shape[2])


def plain_reasons(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> List[str]:
    """Why a call of `layers.dot_attention` (q (B,T,H,D), k/v (B,S,H,D))
    keeps the plain version; [] where the kernel takes it. The kernel
    takes a call whose q, k and v are on one card, none requiring grad
    while grad is on, with no bias, fp32, under the TF32 matmul policy
    (`utils/precision.py`: the "ieee" policy keeps the plain version's
    IEEE products), of head dim 64, at least 64 queries and 64 keys, one
    batch and head count, laid out as `_aligned` says."""
    ts = (q, k, v)
    why = []
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        why.append("device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        why.append("grad")
    if bias is not None:
        why.append("bias")
    if any(t.dtype != torch.float32 for t in ts):
        why.append("dtype")
    if torch.backends.cuda.matmul.fp32_precision != "tf32":
        why.append("policy")
    if any(t.shape[-1] != HEAD_DIM for t in ts):
        why.append("head_dim")
    if not _same_frame(q, k, v):
        why.append("shape")
    elif q.shape[1] < MIN_TOKENS or k.shape[1] < MIN_TOKENS:
        why.append("tokens")
    if not all(_aligned(t) for t in ts):
        why.append("layout")
    return why


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """q (B,T,H,64), k/v (B,S,H,64) fp32 CUDA tensors, read through their
    strides → (B,T,H,64) fp32, contiguous: one launch of the fused kernel,
    counted in `attention.launches`. Forward only: raises ValueError on a
    call that autograd would differentiate, as on anything else the kernel
    does not take; RuntimeError if the launch fails."""
    named = (("q", q), ("k", k), ("v", v))
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name} must be (B, tokens, H, {HEAD_DIM}), "
                             f"got {tuple(t.shape)}")
    if not _same_frame(q, k, v):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on batch, heads or keys")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise ValueError("the kernel is forward only: call it with grad off "
                         "or on tensors that require none")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not _aligned(t):
            raise ValueError(f"{name} must have unit stride along the head "
                             "dim, strides in multiples of 4 and a 16-byte "
                             f"aligned base, got strides {t.stride()}")
    B, T, H, _ = q.shape
    S = k.shape[1]
    if min(B, T, S, H) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    out = torch.empty((B, T, H, HEAD_DIM), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with profiling.span("ga.kernel.attn", batch=B, heads=H, queries=T,
                        keys=S):
        rasterize_cuda._raise_on(rasterize_cuda._library("attn").ga_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            stream), "attention")
    attention.launches += 1
    return out


attention.launches = 0
