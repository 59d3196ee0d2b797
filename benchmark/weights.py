"""Seeded weights, made on the device in one draw per model.

The rule depends only on each parameter's name and shape, so the program
and the reference, which name their parameters alike, receive the same
tensors: a matrix or a kernel N(0, 1/fan_in); a bias N(0, 0.02²); a norm's
weight 1 + N(0, 0.05²); DINOv2's layer scales 0.1 + N(0, 0.02²); LPIPS's
non-negative channel weights 0.01 + N(0, 0.002²); learned
tokens, position tables and adaLN tables N(0, 0.02²). The output heads
are smaller, so that what they produce has a trained model's scale: the
DiTs' final projection at 0.2 of the rule above (velocities of order 1,
so the sampled point cloud and latent stay near unit scale), the surfel
heads at 0.5 (surfels of a few thousandths of the scene, as the release
decoder's, not ones that cover the image).
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...]]

_TABLES = ("pos_embed", "cls_token", "register_tokens", "latent_embedding",
           "scale_shift_table")


def rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(std, mean) of a parameter."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _TABLES:
        return 0.02, 0.0
    if leaf == "gamma":
        return 0.02, 0.1
    if name.startswith("lins."):        # LPIPS's channel weights: >= 0
        return 0.002, 0.01
    if len(shape) >= 2:
        std = 1.0 / math.sqrt(math.prod(shape[1:]))
        if name.startswith("final_layer.linear"):
            std *= 0.2
        elif "gaussian_pred" in name or "gaussian_residual_pred" in name:
            std *= 0.5
        return std, 0.0
    if leaf == "bias":
        return 0.02, 0.0
    return 0.05, 1.0            # norm weights


def leaves(module: torch.nn.Module) -> List[Leaf]:
    """(name, shape) of every parameter, sorted by name."""
    return sorted((n, tuple(p.shape)) for n, p in module.named_parameters())


def make(seed: int, tag: str, spec: List[Leaf], device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One normal draw for the whole model from (seed, tag), cut into the
    leaves of `spec` and scaled by `rule`; the leaves are views of one
    buffer."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + zlib.crc32(tag.encode()))
                    % (2 ** 63))
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, o = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        std, mean = rule(name, shape)
        out[name] = flat[o:o + n].view(shape).mul_(std).add_(mean)
        o += n
    return out


def load(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """Assign `tensors` as `module`'s parameters (a module on the meta
    device takes them without a copy); every name must match."""
    missing = set(dict(module.named_parameters())) ^ set(tensors)
    if missing:
        raise KeyError(f"parameters differ by name: {sorted(missing)[:8]}")
    module.load_state_dict(tensors, strict=False, assign=True)
    return module
