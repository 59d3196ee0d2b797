"""Device selection and the fp32 precision policy shared by entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, refusing CUDA when there is none.

    Also pins true-fp32 products on the card: matmuls and cuDNN convolutions
    default to TF32 otherwise (DINOv2's `patch_embed` conv would lose about
    three decimal digits), the Hopper counterpart of the JAX package's
    `Precision.HIGHEST` rule for parity-critical products.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
