"""Device selection and the matmul precision policy shared by entry points."""
from __future__ import annotations

import torch

from gaussiananything_tpu_torch.utils.precision import set_policy


def resolve_device(device="cuda", matmul_precision: str = "default"
                   ) -> torch.device:
    """Return `device` as a torch.device, refusing CUDA when there is none.

    Also sets the process's matmul precision policy
    (`utils.precision.set_policy`), the counterpart of JAX's
    `jax_default_matmul_precision`: "default" computes cuBLAS matmuls and
    cuDNN convolutions in TF32, as the JAX package's `Precision.DEFAULT`
    products run on an H100; "highest" computes them in IEEE fp32. The
    JAX package's `Precision.HIGHEST` products are IEEE under either
    policy (`utils.precision.highest_*`). The entry points take the
    default; checks that hold the card to the CPU, an oracle or an
    unsharded step pass "highest".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    set_policy(matmul_precision)
    return dev
