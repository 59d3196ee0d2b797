"""Process groups and rank helpers (port of
`gaussiananything_tpu/parallel/dist.py`; the reference's
`guided_diffusion/dist_util.py`).

A multi-GPU run is one process per rank, started by a launcher such as
`python -m torch.distributed.run --nproc_per_node N ...`, which gives each
process RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT in its
environment. `setup_dist` joins the group those describe; a single process
(no WORLD_SIZE, or 1) is left alone and every helper below is then a
no-op.

The backend is NCCL, which needs a card of its own for each rank. Any other
backend is asked for by name: `gloo` puts several ranks on one card (it
takes `all_reduce` and `broadcast` on CUDA tensors, which is all the port
uses). Nothing here switches the backend or the device on its own.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def setup_dist(backend: Optional[str] = None) -> None:
    """Join the process group of torchrun's environment (parity:
    `setup_dist`, `guided_diffusion/dist_util.py:57`). No-op for a single
    process or when the group exists. backend: None → "nccl"; NCCL pins
    rank r to card LOCAL_RANK and raises when the host has fewer cards
    than local ranks."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        n_cards = torch.cuda.device_count()
        if local_world > n_cards:
            raise RuntimeError(
                f"NCCL needs a card for each of the {local_world} ranks on "
                f"this host, which has {n_cards}: start fewer ranks, or ask "
                f"for another backend by name (--dist-backend gloo)")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method="env://")


def rank_device(device) -> torch.device:
    """The device of this rank: with NCCL, card LOCAL_RANK (as
    `setup_dist` pinned it) for a CUDA `device` given without an index;
    otherwise `device` as given (gloo ranks share the card they name)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier over every rank (parity: `dist_util.synchronize`)."""
    if get_world_size() > 1:
        dist.barrier()


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a global batch (parity with the InfiniteSampler
    rank-sharding, `dnnlib/util.py:548-586`)."""
    per = global_batch // get_world_size()
    r = get_rank()
    return slice(r * per, (r + 1) * per)


def group_size(group) -> int:
    """Ranks in `group`; None stands for a group of this process alone."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all_reduce over `group` (nothing for a group of one)."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


class _SumReplicated(torch.autograd.Function):
    """Σ over the group's ranks of x, for a result every rank then uses
    alike (a replicated loss). Each rank's share of the cotangent is the
    full one; the gradient is `group size` times it, so that averaging the
    parameter gradients over the group (what the trainers do) gives the
    gradient of the replicated loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group_size(group)
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.n, None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable Σ over the ranks of `group` (see `_SumReplicated`)."""
    if group_size(group) == 1:
        return x
    return _SumReplicated.apply(x, group)


def average_(tree: dict, group) -> dict:
    """The mean over `group` of every tensor of a dict of gradients, in
    place, through ONE flat all_reduce (the counterpart of the psum XLA
    compiles into the JAX package's sharded step); returns `tree`."""
    n = group_size(group)
    if n == 1 or not tree:
        return tree
    keys = list(tree)
    flat = torch.cat([tree[k].reshape(-1).float() for k in keys])
    all_reduce_(flat, group)
    flat.div_(n)
    offset = 0
    for k in keys:
        t = tree[k]
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tree


def mean_scalars(logs: dict, group, skip=()) -> dict:
    """{name: 0-dim tensor} → the mean of each over `group` (one
    all_reduce); the names in `skip` (values already equal on every rank)
    pass unchanged."""
    keys = [k for k in logs if k not in skip]
    if group_size(group) == 1 or not keys:
        return logs
    vals = torch.stack([torch.as_tensor(logs[k]).float().reshape(())
                        for k in keys])
    all_reduce_(vals, group)
    vals = vals / group_size(group)
    return {**logs, **{k: vals[i] for i, k in enumerate(keys)}}


def broadcast_generator(gen: torch.Generator, device=None) -> None:
    """Rank 0's state of a host generator on every rank (after rank 0
    alone drew from it, as in an evaluation). `device`: where the state
    travels (NCCL takes CUDA tensors only)."""
    if get_world_size() == 1:
        return
    state = gen.get_state()
    if device is not None:
        state = state.to(device)
    dist.broadcast(state, src=0)
    gen.set_state(state.cpu())
