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
    keeps the plain version for a call, empty where it takes the kernel:
    what the kernel cannot take (`_refusals`, whose messages `attention`
    raises) and what the route leaves plain by choice.

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
library is built and loaded by `ops/kernel_lib`.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from gaussiananything_tpu_torch.ops import kernel_lib
from gaussiananything_tpu_torch.utils import profiling

HEAD_DIM = 64
# below a tile of 64 queries or keys the kernel's tiles are mostly padding:
# the upsamplers' 4-9-token groups stay plain
MIN_TOKENS = 64

_SIGNATURES = {"ga_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]}


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


def _same_frame(q, k, v) -> bool:
    return (q.dim() == k.dim() == v.dim() == 4 and k.shape == v.shape
            and q.shape[0] == k.shape[0] and q.shape[2] == k.shape[2])


def _refusals(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> List[Tuple[str, str]]:
    """What the kernel cannot take in a call, as (reason, message) pairs;
    [] where it takes the call. It takes q (B,T,H,64) and k/v (B,S,H,64)
    on one card, none requiring grad while grad is on, fp32, laid out as
    `kernel_lib.aligned16` says, none empty."""
    ts = (q, k, v)
    shapes = f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
    why = []
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        why.append(("device", "q, k and v must be CUDA tensors on one "
                    f"card, got {q.device}, {k.device}, {v.device}"))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        why.append(("grad", "the kernel is forward only: call it with grad "
                    "off or on tensors that require none"))
    if any(t.dtype != torch.float32 for t in ts):
        why.append(("dtype", "q, k and v must be float32, got "
                    f"{q.dtype}, {k.dtype}, {v.dtype}"))
    if any(t.shape[-1] != HEAD_DIM for t in ts):
        why.append(("head_dim", f"q, k and v must be (B, tokens, H, "
                    f"{HEAD_DIM}), got {shapes}"))
    if not _same_frame(q, k, v):
        why.append(("shape", "q, k and v are not 4-dim or disagree on "
                    f"batch, heads or keys: {shapes}"))
    elif q.numel() == 0 or k.numel() == 0:
        why.append(("empty", f"empty attention: {shapes}"))
    if not all(kernel_lib.aligned16(t) for t in ts):
        why.append(("layout", "q, k and v must have unit stride along the "
                    "head dim, strides in multiples of 4 and a 16-byte "
                    f"aligned base, got strides {q.stride()}, {k.stride()}, "
                    f"{v.stride()}"))
    return why


def plain_reasons(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> List[str]:
    """Why a call of `layers.dot_attention` (q (B,T,H,D), k/v (B,S,H,D))
    keeps the plain version; [] where the kernel takes it. Besides what the
    kernel cannot take (`_refusals`), the route keeps a call with a bias,
    one under the "ieee" matmul policy (`utils/precision.py`: the plain
    version's IEEE products) and one of fewer than 64 queries or keys."""
    why = [reason for reason, _ in _refusals(q, k, v)]
    if bias is not None:
        why.append("bias")
    if torch.backends.cuda.matmul.fp32_precision != "tf32":
        why.append("policy")
    if _same_frame(q, k, v) and min(q.shape[1], k.shape[1]) < MIN_TOKENS:
        why.append("tokens")
    return why


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """q (B,T,H,64), k/v (B,S,H,64) fp32 CUDA tensors, read through their
    strides → (B,T,H,64) fp32, contiguous: one launch of the fused kernel,
    counted in `attention.launches`. Forward only: raises ValueError on a
    call that autograd would differentiate, as on anything else the kernel
    does not take; RuntimeError if the launch fails."""
    kernel_lib.refuse(_refusals(q, k, v))
    B, T, H, _ = q.shape
    S = k.shape[1]
    out = torch.empty((B, T, H, HEAD_DIM), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with profiling.span("ga.kernel.attn", batch=B, heads=H, queries=T,
                        keys=S):
        kernel_lib.check(kernel_lib.library("attn", _SIGNATURES).ga_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            stream), "attention")
    attention.launches += 1
    return out


attention.launches = 0
