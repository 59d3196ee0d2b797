"""The data × tile mesh of ranks and the batch rules (port of
`gaussiananything_tpu/parallel/mesh.py`; the reference's DDP stack,
`guided_diffusion/dist_util.py:57-132`, `nsr/train_util.py:185-195`).

A mesh is one process per rank. Rank r sits at (r // tile, r % tile), the
order of the JAX package's `np.asarray(devices).reshape(data, tile)`.

Axes:
  * `data` — each rank along it holds its slice of the global batch; the
    trainers average the gradients over it before the optimizer.
  * `tile` — each rank along it renders a band of every view's rows
    (`render/sharded.py`); the splats are replicated, the band maps joined
    and the splat gradients summed over it.

Each rank has a data group (the ranks of its tile index, one per data
slice) and a tile group (the ranks of its data slice). Both are None in a
single process, where every collective is a no-op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from gaussiananything_tpu_torch.parallel.dist import get_rank, get_world_size


@dataclasses.dataclass(eq=False)
class Mesh:
    data: int
    tile: int
    rank: int
    data_group: Any = None      # torch.distributed group, None alone
    tile_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "tile": self.tile}

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile

    def layout(self) -> np.ndarray:
        """(data, tile) rank numbers: rank r at (r // tile, r % tile)."""
        return np.arange(self.data * self.tile).reshape(self.data, self.tile)


def make_mesh(data: Optional[int] = None, tile: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one process: 1 × 1).
    data None → world // tile. Every rank must call this, in the same
    order as its other group creations: it creates the data and tile
    groups of every rank."""
    n = get_world_size()
    if data is None:
        data = n // tile
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} needs {data * tile} ranks, "
                         f"the process group has {n}")
    mesh = Mesh(data, tile, get_rank())
    if n == 1:
        return mesh
    grid = mesh.layout()
    for t in range(tile):
        g = dist.new_group([int(r) for r in grid[:, t]])
        if t == mesh.tile_index:
            mesh.data_group = g if data > 1 else None
    for d in range(data):
        g = dist.new_group([int(r) for r in grid[d]])
        if d == mesh.data_index:
            mesh.tile_group = g if tile > 1 else None
    return mesh


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, micro: int = 1):
    """This rank's rows of the leading (batch) dimension of every tensor
    or array of `tree` (dicts, lists, tuples); 0-dim leaves and other
    values pass whole.

    The global batch of B rows is `micro` micro-batches of B / micro rows
    (the trainers' `accum`), each split over the mesh's R = `mesh.data`
    data slices: rank r receives, for each micro-batch i in order, the
    rows [i·B/micro + r·B/(micro·R), i·B/micro + (r+1)·B/(micro·R)),
    concatenated. So the rank's micro-batch i is its slice of the global
    micro-batch i, as the JAX package's accumulation under a sharded batch
    takes it (a `dynamic_slice` of the global batch,
    `gaussiananything_tpu/train/fm_trainer.py:122-135`), and a sharded
    accumulation step equals the unsharded one. With `micro` 1 the rows
    are one contiguous block [r·B/R, (r+1)·B/R)."""
    def _shard(x):
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)) \
                or x.ndim == 0:
            return x
        B, rest = x.shape[0], tuple(x.shape[1:])
        if B % (micro * mesh.data):
            raise ValueError(
                f"a batch of {B} does not split into {micro} micro-batches "
                f"over the mesh's {mesh.data} data slices: it must be a "
                f"multiple of {micro * mesh.data}")
        per = B // (micro * mesh.data)
        return x.reshape((micro, mesh.data, per) + rest)[
            :, mesh.data_index].reshape((micro * per,) + rest)

    return _map(_shard, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` (or every parameter and buffer of a module)
    broadcast from rank 0, in place; returns `tree`."""
    if get_world_size() == 1:
        return tree
    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            dist.broadcast(t.data, src=0)
        return tree

    def _bcast(x):
        if torch.is_tensor(x):
            dist.broadcast(x.data, src=0)
        return x

    _map(_bcast, tree)
    return tree



def training_mesh(mesh_data: int, mesh_tile: int, batch: int,
                  micro: int = 1) -> Mesh:
    """The training CLIs' mesh over the ranks the launcher started:
    data = mesh_data or gcd(batch, world // mesh_tile), as the JAX CLIs
    take it over the devices. A launcher chooses the process count, so a
    world size other than data × tile is refused, not cut to fit; so is a
    batch that `micro` micro-batches (`--accum`) over the data slices do
    not split (`shard_batch`)."""
    world = get_world_size()
    tile = max(1, mesh_tile)
    data = mesh_data or math.gcd(batch, max(1, world // tile))
    if data * tile != world:
        raise ValueError(
            f"the mesh is {data} (data) x {tile} (tile) = {data * tile} "
            f"ranks (mesh_data={mesh_data}, mesh_tile={mesh_tile}, batch "
            f"{batch}), but {world} were started: launch {data * tile} "
            f"processes or set mesh_data/mesh_tile to fit {world}")
    if batch % (micro * data):
        raise ValueError(
            f"a batch of {batch} does not split into {micro} micro-batches "
            f"(--accum) over the mesh's {data} data slices: the batch must "
            f"be a multiple of {micro * data}")
    return make_mesh(data, tile)
