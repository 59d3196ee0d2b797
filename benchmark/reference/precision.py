"""The reference's arithmetic and its lower-precision control.

The reference runs every product in IEEE fp32 (`ieee()` turns TF32 off
for cuBLAS and cuDNN while it runs). Its control is the same reference one
step below what the configuration states:

  * the model's products (`net`): a configuration whose compute dtype is
    fp32 with TF32 products computes them in bf16; one whose compute dtype
    is bf16 rounds their operands to fp8 (e4m3, each tensor scaled so
    that its largest magnitude meets e4m3's largest finite value, as an
    fp8 recipe scales it) first. The rounding is the forward's alone: the
    backward passes the cotangent through unrounded, so the gradients are
    bf16 products of the rounded operands, as an fp8 forward trains;
  * the training losses' networks (`aux`: VGG-LPIPS and the PatchGAN,
    TF32 products in the program) in bf16;
  * the products the configuration states in IEEE fp32 (cameras, rays,
    resizes, the compositor's tile sums) with their operands rounded to
    TF32 (`geom`).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class Policy:
    net: torch.dtype = torch.float32    # dtype of the model's products
    net_fp8: bool = False               # round their operands to e4m3
    aux: torch.dtype = torch.float32    # dtype of the losses' networks
    tf32_geometry: bool = False         # round geometry operands to TF32


POLICY = Policy()


@contextlib.contextmanager
def policy(**kw):
    old = dataclasses.replace(POLICY)
    for k, v in kw.items():
        setattr(POLICY, k, v)
    try:
        yield POLICY
    finally:
        for f in dataclasses.fields(Policy):
            setattr(POLICY, f.name, getattr(old, f.name))


def control(compute_dtype: str = "float32"):
    """The control's policy for a configuration's compute dtype."""
    if compute_dtype == "bfloat16":
        return policy(net=torch.bfloat16, net_fp8=True, aux=torch.bfloat16,
                      tf32_geometry=True)
    return policy(net=torch.bfloat16, aux=torch.bfloat16,
                  tf32_geometry=True)


E4M3_MAX = 448.0


class _E4M3(torch.autograd.Function):
    """Round to e4m3 under a per-tensor scale in the forward; pass the
    cotangent through in the backward."""

    @staticmethod
    def forward(ctx, t):
        x = t.detach().float()
        amax = x.abs().amax()
        scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
        q = (x * scale).to(torch.float8_e4m3fn).float() / scale
        return q.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def net(t):
    """A model product's operand."""
    if t is None:
        return None
    if POLICY.net_fp8:
        t = _E4M3.apply(t)
    return t.to(POLICY.net)


def aux(t):
    """A loss network's operand."""
    return None if t is None else t.to(POLICY.aux)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest TF32 value (10 mantissa bits, ties away
    from zero), as a tensor core reads an fp32 operand."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def geom(x: torch.Tensor) -> torch.Tensor:
    """A geometry product's operand: as it is, or TF32 in the control."""
    return tf32_round(x) if POLICY.tf32_geometry else x


def _set_fp32(value: str):
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    old = (m.fp32_precision, c.fp32_precision)
    m.fp32_precision, c.fp32_precision = value, value
    return old


@contextlib.contextmanager
def ieee():
    """IEEE fp32 for every cuBLAS product and cuDNN convolution inside
    (the flags PyTorch reads instead of the legacy `allow_tf32`)."""
    old = _set_fp32("ieee")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision = old[0]
        torch.backends.cudnn.conv.fp32_precision = old[1]
