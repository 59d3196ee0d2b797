"""One-pass row normalisation: the plain version and the hand-written kernel.

Over rows of width D (the last dim), with per-batch vectors gate, shift and
scale of shape (B, D) indexed by each row's batch (the first dim):

    x' = x + gate·y,  or x + y,  or x
    h  = x' · rsqrt(mean(x'²) + eps) · weight             (`layers.RMSNorm`)
    h  = h · (1 + scale) + shift                           (`layers.modulate`)

  * `rownorm_plain(...)` → (x', h): those expressions in PyTorch, the ones
    the DiT blocks wrote before the kernel, in the same order (h is None
    without a weight: a residual alone). It runs on any device and dtype and
    under autograd.
  * `rownorm(...)` → (x', h): one launch of `csrc/rownorm.cu` on fp32 CUDA
    tensors; x' is x itself where no residual is added, h None where no
    weight is given (the residual-only mode). `rownorm_pair` normalises two
    tensors of one width with their own weights in one launch: the q and
    the k heads of an attention.
  * `plain_reasons(...)`: why a call keeps the plain version, empty where
    the kernel takes it: the reasons of `_refusals`, the one statement of
    what the kernel takes, whose messages the wrappers raise.
    `models/layers.norm_rows` and `layers.qk_norms` route by it, and count
    in `plain`, by reason, each norm on a CUDA tensor that stays plain.

The kernel replaces no TPU kernel: the JAX package leaves these expressions
to XLA. It was added because in PyTorch each operation is a launch of its
own, and a release DiT-L block made ~55 of them (six a `RMSNorm`, three a
`modulate`, two a gated residual); the fused kernel makes six. What bounds
it: bytes. The block's fused residual + norm + modulate at (2, 768, 1024)
moves 25 MB, 7.5 µs at 3.35 TB/s. The design notes are in the source.

`rownorm` and `rownorm_pair` count their launches in `rownorm.launches` and
the norms they computed in `rownorm.norms`, and open the span
`ga.kernel.rownorm` around each launch (`utils/profiling.py`); a launch
recorded into a CUDA graph (`models/dit._ForwardGraphs`) counts and opens its
span once, at the capture. The library is built and loaded by
`ops/kernel_lib`.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from gaussiananything_tpu_torch.ops import kernel_lib
from gaussiananything_tpu_torch.utils import profiling

# the widest row the kernel holds in registers (eight 16-byte loads a lane)
MAX_WIDTH = 1024

_SIGNATURES = {"ga_rownorm": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]}

# norms on a CUDA tensor that kept the plain version, by their reasons
# joined with "+" (`layers.norm_rows`, `layers.qk_norms`)
plain = collections.Counter()

Opt = Optional[torch.Tensor]


def _per_batch(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, D) → (B, 1, …, 1, D), broadcasting over x's middle dims."""
    return v.reshape((v.shape[0],) + (1,) * (x.dim() - 2) + v.shape[-1:])


def rownorm_plain(x: torch.Tensor, y: Opt = None, gate: Opt = None,
                  weight: Opt = None, eps: float = 1e-5, shift: Opt = None,
                  scale: Opt = None) -> Tuple[torch.Tensor, Opt]:
    """(x', h) as the module docstring defines them; h is computed in fp32
    whatever the dtypes (`RMSNorm`)."""
    if y is not None:
        x = x + (y if gate is None else _per_batch(gate, x) * y)
    if weight is None:
        return x, None
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    h = xf * torch.rsqrt(ms + eps) * weight.float()
    if scale is not None:
        h = h * (1 + _per_batch(scale, x)) + _per_batch(shift, x)
    return x, h


def _laid_out(rows: Sequence[Opt], vectors: Sequence[Opt]) -> bool:
    """The rows `kernel_lib.aligned16`; the weights and the per-batch
    vectors of unit stride along D, at any offset (the kernel reads them a
    float at a time unless all are aligned)."""
    return (all(kernel_lib.aligned16(t) for t in rows if t is not None)
            and all(t.stride(-1) == 1 for t in vectors if t is not None))


def _shapes_ok(x, y, gate, weight, shift, scale) -> bool:
    """x of 2 to 4 dims, y of its shape, a gate only with y, shift and
    scale together and only with a weight, each (B, D) of a 3- or 4-dim
    x, the weight (D,)."""
    D = x.shape[-1]
    if not 2 <= x.dim() <= 4 or (y is not None and y.shape != x.shape):
        return False
    if (gate is not None and y is None) or (shift is None) != (scale is None) \
            or (scale is not None and weight is None):
        return False
    if weight is not None and tuple(weight.shape) != (D,):
        return False
    return all(v is None or (x.dim() >= 3
                             and tuple(v.shape) == (x.shape[0], D))
               for v in (gate, shift, scale))


def _refusals(x: torch.Tensor, y: Opt = None, gate: Opt = None,
              weight: Opt = None, shift: Opt = None, scale: Opt = None,
              k: Opt = None, k_weight: Opt = None) -> List[Tuple[str, str]]:
    """What the kernel cannot take in a launch, as (reason, message) pairs;
    [] where it takes the launch. It takes tensors on one card, none
    requiring grad while grad is on, fp32, of a width D that is a multiple
    of 4 and at most MAX_WIDTH, shaped as `_shapes_ok` says, laid out as
    `_laid_out` says, not empty, with y, a weight or both to compute. `k`
    and `k_weight` are the second job of a pair (`rownorm_pair`): a norm
    alone, of x's width."""
    named = [(n, t) for n, t in (("x", x), ("y", y), ("gate", gate),
                                 ("weight", weight), ("shift", shift),
                                 ("scale", scale), ("k", k),
                                 ("k_weight", k_weight)) if t is not None]
    ts = [t for _, t in named]
    D = x.shape[-1]

    def listed(what):       # each tensor's `what`, for a message
        return ", ".join(f"{n} {what(t)}" for n, t in named)

    why = []
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        why.append(("device", "the tensors must be CUDA tensors on one card, "
                    "got " + listed(lambda t: f"on {t.device}")))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        why.append(("grad", "the kernel is forward only: call it with grad "
                    "off or on tensors that require none"))
    if any(t.dtype != torch.float32 for t in ts):
        why.append(("dtype", "the tensors must be float32, got "
                    + listed(lambda t: t.dtype)))
    if D % 4 or not 4 <= D <= MAX_WIDTH:
        why.append(("width", f"rows must be a multiple of 4 wide, 4 to "
                    f"{MAX_WIDTH}, got {D}"))
    if k is not None and k.shape[-1] != D:
        why.append(("widths", f"q and k differ in width: {tuple(x.shape)}, "
                    f"{tuple(k.shape)}"))
    if not _shapes_ok(x, y, gate, weight, shift, scale) or (
            k is not None and not _shapes_ok(k, None, None, k_weight, None,
                                             None)):
        why.append(("shape", "x takes y of its shape, a gate only with y, "
                    "shift and scale together and only with a weight, each "
                    "(B, D) of a 3- or 4-dim x, a weight (D,); got "
                    + listed(lambda t: tuple(t.shape))))
    if not _laid_out((x, y, k), (gate, weight, shift, scale, k_weight)):
        why.append(("layout", "rows need unit stride, strides in multiples "
                    "of 4 and a 16-byte aligned base, weights and vectors "
                    "unit stride; got " + listed(lambda t: t.stride())))
    if x.numel() == 0 or (k is not None and k.numel() == 0):
        why.append(("empty", "no rows: " + listed(lambda t: tuple(t.shape))))
    if y is None and weight is None:
        why.append(("nothing", "nothing to compute: give y, a weight or "
                    "both"))
    return why


def plain_reasons(x: torch.Tensor, y: Opt = None, gate: Opt = None,
                  weight: Opt = None, shift: Opt = None, scale: Opt = None,
                  k: Opt = None, k_weight: Opt = None) -> List[str]:
    """Why a call keeps the plain version; [] where the kernel takes it:
    the reasons of `_refusals`. No product is involved, so the matmul
    policy is not read."""
    return [reason for reason, _ in _refusals(x, y, gate, weight, shift,
                                              scale, k, k_weight)]


class _Job(ctypes.Structure):
    """`struct Job` of `csrc/rownorm.cu`: strides in floats."""
    _fields_ = [("x", ctypes.c_void_p), ("xb", ctypes.c_longlong),
                ("xn", ctypes.c_longlong), ("xh", ctypes.c_longlong),
                ("y", ctypes.c_void_p), ("yb", ctypes.c_longlong),
                ("yn", ctypes.c_longlong), ("yh", ctypes.c_longlong),
                ("gate", ctypes.c_void_p), ("gb", ctypes.c_longlong),
                ("w", ctypes.c_void_p),
                ("shift", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("scale", ctypes.c_void_p), ("cb", ctypes.c_longlong),
                ("xo", ctypes.c_void_p), ("ho", ctypes.c_void_p),
                ("B", ctypes.c_longlong), ("N", ctypes.c_longlong),
                ("H", ctypes.c_longlong), ("eps", ctypes.c_float),
                ("vec4", ctypes.c_int)]


def _frame(t: torch.Tensor):
    """(B, N, H) and their strides of t's leading dims, 2 to 4 of them."""
    shape, stride = list(t.shape[:-1]), list(t.stride()[:-1])
    while len(shape) < 3:
        shape.insert(0 if len(shape) == 1 else 2, 1)
        stride.insert(0 if len(stride) == 1 else 2, 0)
    return shape, stride


def _ptr(t: Opt) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _job(x, y, gate, weight, eps, shift, scale):
    """One job of a launch that `_refusals` takes; returns the job, x', h."""
    (B, N, H), (xb, xn, xh) = _frame(x)
    ys = _frame(y)[1] if y is not None else (0, 0, 0)
    xo = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if y is not None else None
    ho = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if weight is not None else None
    job = _Job(_ptr(x), xb, xn, xh, _ptr(y), *ys,
               _ptr(gate), 0 if gate is None else gate.stride(0),
               _ptr(weight),
               _ptr(shift), 0 if shift is None else shift.stride(0),
               _ptr(scale), 0 if scale is None else scale.stride(0),
               _ptr(xo), _ptr(ho), B, N, H, float(eps),
               all(kernel_lib.aligned16(t)
                   for t in (gate, weight, shift, scale) if t is not None))
    return job, (x if xo is None else xo), ho


def _launch(jobs, D: int, device: torch.device, norms: int, **frame):
    lib = kernel_lib.library("rownorm", _SIGNATURES)
    arr = (_Job * len(jobs))(*jobs)
    stream = torch.cuda.current_stream(device).cuda_stream
    with profiling.span("ga.kernel.rownorm", width=D, **frame):
        err = lib.ga_rownorm(ctypes.addressof(arr), len(jobs), D, stream)
        kernel_lib.check(err, "rownorm")
    rownorm.launches += 1
    rownorm.norms += norms


def rownorm(x: torch.Tensor, y: Opt = None, gate: Opt = None,
            weight: Opt = None, eps: float = 1e-5, shift: Opt = None,
            scale: Opt = None) -> Tuple[torch.Tensor, Opt]:
    """(x', h) of fp32 CUDA tensors read through their strides, each output
    new and contiguous (x' is x itself where y is None; h is None where the
    weight is): one launch of the kernel. Forward only: raises ValueError
    on a call that autograd would differentiate, as on anything else the
    kernel does not take; RuntimeError if the launch fails."""
    kernel_lib.refuse(_refusals(x, y, gate, weight, shift, scale))
    job, xo, ho = _job(x, y, gate, weight, eps, shift, scale)
    mode = ("residual" if y is not None else "") + \
        ("+norm" if weight is not None else "") + \
        ("+modulate" if shift is not None else "")
    _launch([job], x.shape[-1], x.device, int(weight is not None),
            rows=x.numel() // x.shape[-1], mode=mode.lstrip("+"))
    return xo, ho


def rownorm_pair(q: torch.Tensor, q_weight: torch.Tensor, q_eps: float,
                 k: torch.Tensor, k_weight: torch.Tensor, k_eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The norms of q and of k, each with its own weight and eps, in one
    launch: (h_q, h_k), new and contiguous. q and k have one width; each is
    taken as `rownorm(t, weight=w, eps=eps)` takes it."""
    kernel_lib.refuse(_refusals(q, weight=q_weight, k=k, k_weight=k_weight))
    jq, _, hq = _job(q, None, None, q_weight, q_eps, None, None)
    jk, _, hk = _job(k, None, None, k_weight, k_eps, None, None)
    _launch([jq, jk], q.shape[-1], q.device, 2,
            rows=(q.numel() + k.numel()) // q.shape[-1], mode="qk")
    return hq, hk


rownorm.launches = 0
rownorm.norms = 0
