"""Rank functions for the port's multi-rank CPU tests
(`test_torch_sharded.py`, `test_torch_parallel.py`): each joins a gloo
group on 127.0.0.1, runs its part on tensors a test saved with
`torch.save`, and rank 0 saves what the test compares. No JAX here: the
ranks start as fresh processes and import only the port."""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(fn, world: int, *args):
    """Start `world` ranks of fn(rank, world, port, *args) without waiting;
    `.join()` the returned context (it raises if a rank failed)."""
    return mp.start_processes(fn, args=(world, free_port()) + args,
                              nprocs=world, join=False,
                              start_method="spawn")


def run(fn, world: int, *args):
    ctx = start(fn, world, *args)
    while not ctx.join():
        pass


def _init(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)


def sharded_render(rank, world, port, inputs, out):
    """`render_view_sharded` on a 1 × world mesh (plain compositor): the
    full maps and the gradient of Σ maps · weights."""
    from gaussiananything_tpu_torch.parallel.mesh import make_mesh
    from gaussiananything_tpu_torch.render.sharded import render_view_sharded
    _init(rank, world, port)
    d = torch.load(inputs)
    mesh = make_mesh(data=1, tile=world)
    g = d["g"].clone().requires_grad_(True)
    maps = render_view_sharded(mesh, g, d["cv"], d["cvp"], torch.ones(3),
                               d["res"], max_per_tile=d["mpt"],
                               chunk=d["chunk"], impl="plain")
    loss = sum((maps[k] * w).sum() for k, w in d["wts"].items())
    loss.backward()
    if rank == 0:
        torch.save({"maps": {k: v.detach() for k, v in maps.items()},
                    "grad": g.grad}, out)
    dist.destroy_process_group()


def _layout(mesh, rank, world):
    """Every rank's mesh position, `local_batch_slice(8)` and shard of an
    (8, 3) batch, gathered by a sum of one-hot rows."""
    from gaussiananything_tpu_torch.parallel.dist import local_batch_slice
    from gaussiananything_tpu_torch.parallel.mesh import shard_batch
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    sl = local_batch_slice(8)
    shard = shard_batch(mesh, x).reshape(-1)
    row = torch.zeros(world, 4 + shard.numel())
    row[rank, :4] = torch.tensor([mesh.data_index, mesh.tile_index,
                                  sl.start, sl.stop], dtype=torch.float32)
    row[rank, 4:] = shard
    dist.all_reduce(row)
    return row


def vae_step(rank, world, port, inputs, out):
    """One VAE step of `make_train_step(mesh=...)` on a data × tile mesh
    (`inputs`: weights, global batch, draws, loss and optimizer settings,
    the perceptual net's weights), and the ranks' layout (`_layout`)."""
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.parallel.mesh import (make_mesh,
                                                          shard_batch)
    from gaussiananything_tpu_torch.train.losses import PerceptualNet
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    from gaussiananything_tpu_torch.train.vae_trainer import (
        VAELossConfig, make_train_step)
    _init(rank, world, port)
    d = torch.load(inputs)
    mesh = make_mesh(*d["mesh"])
    layout = _layout(mesh, rank, world)
    model = PointVAE(**d["sizes"])
    model.load_state_dict(d["weights"])
    net = PerceptualNet()
    net.load_state_dict(d["perceptual"])
    step = make_train_step(model, VAELossConfig(**d["loss"]),
                           TrainStateConfig(**d["tx"]),
                           perceptual_net=net.requires_grad_(False),
                           mesh=mesh)
    state = TrainState.create(model)
    logs = step(state, shard_batch(mesh, d["batch"]), draws=d["draws"])
    if rank == 0:
        torch.save({"logs": {k: float(v) for k, v in logs.items()},
                    "params": {k: v.detach() for k, v in
                               state.params.items()},
                    "layout": layout}, out)
    dist.destroy_process_group()


def fm_step(rank, world, port, out):
    """`parallel.dryrun.fm_step` on a data-parallel mesh of every rank."""
    from gaussiananything_tpu_torch.parallel.dryrun import fm_step as step
    from gaussiananything_tpu_torch.parallel.mesh import make_mesh
    _init(rank, world, port)
    logs = step(2 * world, make_mesh(data=world, tile=1), "cpu")
    if rank == 0:
        torch.save(logs, out)
    dist.destroy_process_group()
