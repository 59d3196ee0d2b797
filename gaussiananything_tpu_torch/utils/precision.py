"""The JAX package's matmul precision policy on the card.

The JAX package chooses a precision per product. Its networks run at
`Precision.DEFAULT` (no flax module passes `precision=`), which on an H100
is TF32; its named geometry products run at `Precision.HIGHEST`, IEEE fp32
(`jax.lax.Precision`: "DEFAULT ... On GPU: uses tensorfloat32 if
available ... HIGHEST ... On GPU: uses float32").

The port keeps the same split:

* `set_policy` sets the process policy, the counterpart of JAX's
  `jax_default_matmul_precision`: "default" gives cuBLAS matmuls and cuDNN
  convolutions TF32, "highest" gives both IEEE fp32
  (`torch.backends.cuda.matmul.fp32_precision`,
  `torch.backends.cudnn.conv.fp32_precision`; the legacy `allow_tf32`
  flags are not used: mixing the two APIs raises when either is read).
  `utils.device.resolve_device` calls it; the entry points take
  "default", the checks that hold the card to the CPU, an oracle or an
  unsharded step (`tools/golden_parity_512.py`, `parallel/dryrun.py`)
  "highest".
* `highest_matmul`, `highest_bmm`, `highest_einsum` and `highest_inv` run
  one product in IEEE fp32 whatever the process policy is, in the forward
  and in the backward. Every `Precision.HIGHEST` product of the JAX
  package goes through one of them.

Design. The policy is process-wide, not thread-local, and other threads
run products at the same time (the `MultiViewDataset` prefetch thread runs
the postprocess geometry while the main thread trains; `cli/serve.py` is a
threading HTTP server; on CUDA autograd's backward runs on a device
thread). So a HIGHEST product pins IEEE itself on whichever thread runs
it, forward and backward: it takes one process-wide re-entrant lock, sets
the matmul flag to "ieee", launches its product, and restores the flag it
found, on the same thread, before it lets the lock go. cuBLAS reads the
flag when the product is launched, so a HIGHEST launch never sees TF32:
every writer of the flag (`set_policy` too) holds the lock. A DEFAULT
product that another thread launches inside that window runs in IEEE:
slower for one launch, never wrong. The backward recomputes the product
under the same lock (`torch.enable_grad` and `torch.autograd.grad` on the
saved inputs), so it needs no gradient formula of its own; these products
are small (4 × 4 poses, per-pixel rays, resize matrices, the plain
compositors' tile sums), and the recompute costs one more of them.

The compositing kernels are fp32 FMA code and call no cuBLAS; their
wrappers (`ops/rasterize_cuda.py`) and the projection, binning and packing
of `ops/rasterize.py` issue no product through cuBLAS (the projection is
componentwise fma chains, as the JAX package's `ops/rasterize.py:100-104`).
The attention kernel (`csrc/attention.cu`, `ops/attention.attention`) is a
DEFAULT site of its own: its two products run in TF32 on the tensor cores
whatever the flag says, so `models/layers.dot_attention` hands it a call
only where the flag reads "tf32"; under the "ieee" policy every attention
runs `ops/attention.attention_plain`, whose cuBLAS products are IEEE.

Site map: each product of the port, its JAX counterpart, its precision.

| Port site | JAX counterpart | Precision |
|---|---|---|
| `render/cameras.py:38` `world2view` (inverse), `:84` `cam_view @ proj`, `:107` Plücker directions | `jnp.linalg.inv` (LU custom calls, no precision: IEEE), `render/cameras.py:99`, `:209-210` | HIGHEST |
| `ops/pointcloud.py:20` squared distances | `ops/pointcloud.py:21` | HIGHEST |
| `ops/rasterize.py:426`, `:532`, `:600`, `:612` (plain v4 pair) | `ops/rasterize.py:434`, `:556`, `:631`, `:652` | HIGHEST |
| `ops/rasterize.py:1205` (plain list compositor) | the list kernels' HIGHEST products, `rasterize_pallas.py:904` | HIGHEST |
| `data/postprocess.py:39`, `:76`, `:87` | `data/postprocess.py:36-37`, `:84-85`, `:102-103` | HIGHEST |
| `data/postprocess.py:65` inverse | `data/postprocess.py:83`, `:101` `jnp.linalg.inv` (IEEE) | HIGHEST |
| `utils/image.py:64`, `:67` (`resize`: DINOv2 pos-embed, conditioner, trainer, extraction) | `jax.image.resize` (default HIGHEST) | HIGHEST |
| `data/postprocess.py:65` (`fixed @ inv(c2w)`, torch on the dataset's device: the card when training there), `data/synthetic.py:58` (numpy, host), `data/objaverse_raw.py:404` (numpy, host) | `data/postprocess.py:83`, `:101`; `data/synthetic.py:59`; `data/objaverse_raw.py:401`: plain `@`, DEFAULT | DEFAULT, as JAX |
| `models/layers.py` `Linear` (`:151`), `Conv2d`, `SameConv2d`; `ops/attention.py` `attention_plain` (`:51`, `:56`, `models/layers._attend`); `models/openclip_text.py:61`, `:140`; every `nn.Conv2d` in `models/` and `train/losses.py` (`:195`, VGG-LPIPS, PatchGAN) | flax `Dense`/`Conv`, `models/layers.py:47-52`, `train/losses.py:212` | DEFAULT |
| `ops/attention.py` `attention` (`csrc/attention.cu`: Q·Kᵀ and P·V, TF32 `mma.sync`, fp32 scores and softmax), taken by `models/layers.dot_attention` only under "tf32"; the "ieee" policy routes to `attention_plain` | `models/layers.py:47-52` | DEFAULT |
| `diffusion/sampling.py:89` (dopri5's stage combination) | `jax.experimental.ode`'s `jnp.dot` | DEFAULT |

`tests/test_torch_precision.py` proves the map on the CPU with a TF32
emulator (`tests/torch_tf32.py`).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

# the JAX precision name -> the flag value of both cuBLAS and cuDNN
POLICIES = {"default": "tf32", "highest": "ieee"}

_LOCK = threading.RLock()


def set_policy(matmul_precision: str = "default") -> None:
    """Set the process policy: "default" (TF32 matmuls and convolutions,
    JAX's `Precision.DEFAULT` on an H100) or "highest" (IEEE fp32). Raises
    if the name is unknown or the flags do not read back as set."""
    if matmul_precision not in POLICIES:
        raise ValueError(f"matmul_precision must be one of "
                         f"{sorted(POLICIES)}, got {matmul_precision!r}")
    value = POLICIES[matmul_precision]
    with _LOCK:
        torch.backends.cuda.matmul.fp32_precision = value
        torch.backends.cudnn.conv.fp32_precision = value
        got = (torch.backends.cuda.matmul.fp32_precision,
               torch.backends.cudnn.conv.fp32_precision)
    if got != (value, value):
        raise RuntimeError(f"the {matmul_precision!r} policy did not set: "
                           f"matmul and conv fp32_precision read {got}")


@contextmanager
def ieee():
    """IEEE fp32 for the cuBLAS products launched inside, on this thread,
    while the lock is held (the flag is restored before it is released)."""
    with _LOCK:
        prev = torch.backends.cuda.matmul.fp32_precision
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.fp32_precision = prev


class _Highest(torch.autograd.Function):
    """`fn(*tensors)` in IEEE fp32, forward and backward."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with ieee():
            return fn(*tensors)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[1:]
        create_graph = torch.is_grad_enabled()
        with ieee(), torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            grads = iter(torch.autograd.grad(
                ctx.fn(*inputs), [t for t, n in zip(inputs, need) if n],
                grad, create_graph=create_graph))
        return (None,) + tuple(next(grads) if n else None for n in need)


def highest_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` at `Precision.HIGHEST`."""
    return _Highest.apply(torch.matmul, a, b)


def highest_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.bmm(a, b)` at `Precision.HIGHEST`."""
    return _Highest.apply(torch.bmm, a, b)


def highest_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(equation, *operands)` at `Precision.HIGHEST`."""
    return _Highest.apply(lambda *ops: torch.einsum(equation, *ops),
                          *operands)


def highest_inv(a: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.inv(a)` in IEEE fp32 (the JAX package's
    `jnp.linalg.inv` is LU custom calls that take no precision)."""
    return _Highest.apply(torch.linalg.inv, a)
