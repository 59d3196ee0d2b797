"""A TF32 emulator for the CPU tests of the matmul precision policy.

`TF32Emulator` is a `TorchDispatchMode` that catches the fp32 products
cuBLAS and cuDNN compute on the card (`aten.mm`, `bmm`, `addmm`,
`baddbmm`, `convolution`, `convolution_backward`) and reads the same
policy flags the card reads (`torch.backends.cuda.matmul.fp32_precision`
for the matmuls, `torch.backends.cudnn.conv.fp32_precision` for the
convolutions). Where the flag says "tf32" it rounds each fp32 operand to
TF32 (10 mantissa bits, round to nearest even on the bit pattern) before
the op runs; where it says anything else the op runs as it is. The mode
covers the thread that enters it, and the CPU backward that thread runs.
Only the tests that enter it see TF32: a CPU run is otherwise unchanged.
Torch only, no JAX.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# op -> (the policy flag it reads, the positions of its product operands)
_MATMUL = "matmul"
_CONV = "conv"
PRODUCTS = {
    aten.mm.default: (_MATMUL, (0, 1)),
    aten.bmm.default: (_MATMUL, (0, 1)),
    aten.addmm.default: (_MATMUL, (1, 2)),
    aten.baddbmm.default: (_MATMUL, (1, 2)),
    aten.convolution.default: (_CONV, (0, 1)),
    aten.convolution_backward.default: (_CONV, (0, 1, 2)),
}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties to even; inf and NaN kept."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def flag(kind: str) -> str:
    return (torch.backends.cuda.matmul.fp32_precision if kind == _MATMUL
            else torch.backends.cudnn.conv.fp32_precision)


class TF32Emulator(TorchDispatchMode):
    """Round fp32 product operands to TF32 where the policy flag says so.
    `log` records (op, flag) for every product the mode saw."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            kind, slots = PRODUCTS[func]
            value = flag(kind)
            self.log.append((str(func), value))
            if value == "tf32":
                args = list(args)
                for i in slots:
                    a = args[i]
                    if isinstance(a, torch.Tensor) \
                            and a.dtype == torch.float32:
                        args[i] = round_tf32(a)
        return func(*args, **kwargs)
