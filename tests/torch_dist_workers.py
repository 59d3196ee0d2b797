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
    from gaussiananything_tpu_torch.parallel.mesh import make_mesh
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
    logs = step(state, d["batch"], draws=d["draws"])
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


def accum_step(rank, world, port, inputs, out):
    """Two accumulation steps (`accum` micro-batches each) on a
    data-parallel mesh of every rank, from `inputs`' weights, global batch
    and per-step, per-micro-batch draws of the global micro-batches: the
    flow-matching step (`kind` "fm": a stage-1 DiT and an image
    conditioner) or the VAE step (`kind` "vae", `make_accum_train_step`).
    The step keeps each rank's slice of every global micro-batch
    (`shard_batch(..., micro=accum)`). Run once for each of `inputs`'
    `layouts`: "micro" feeds the global batch as it is; "block" feeds it
    reordered (`block_order`) so that each rank's rows are one block, as
    `shard_batch(..., micro=1)` gives them, and micro-batch i is that
    block's slice i. Rank 0 saves each layout's logs and final
    parameters."""
    from gaussiananything_tpu_torch.diffusion.transport import \
        create_transport
    from gaussiananything_tpu_torch.models.conditioner import \
        ImageConditioner
    from gaussiananything_tpu_torch.models.dit import stage1_dit
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.parallel.mesh import make_mesh
    from gaussiananything_tpu_torch.train.fm_trainer import (
        FMConfig, make_fm_train_step)
    from gaussiananything_tpu_torch.train.losses import PerceptualNet
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    from gaussiananything_tpu_torch.train.vae_trainer import (
        VAELossConfig, make_accum_train_step)
    _init(rank, world, port)
    d = torch.load(inputs)
    mesh = make_mesh(data=world, tile=1)
    tx = TrainStateConfig(**d["tx"])
    res = {}
    for layout in d["layouts"]:
        if d["kind"] == "fm":
            dit = stage1_dit("S", **d["dit"])
            dit.load_state_dict(d["dit_weights"])
            cond = ImageConditioner(**d["cond"])
            cond.load_state_dict(d["cond_weights"])
            step = make_fm_train_step(dit.train(), cond.train(),
                                      create_transport(), FMConfig(stage=1),
                                      tx, accum=d["accum"], mesh=mesh)
            state, cstate = TrainState.create(dit), TrainState.create(cond)

            def run(batch, draws):
                return step(state, cstate, batch, draws=draws)
        else:
            model = PointVAE(**d["sizes"])
            model.load_state_dict(d["weights"])
            net = PerceptualNet()
            net.load_state_dict(d["perceptual"])
            step = make_accum_train_step(
                model, VAELossConfig(**d["loss"]), d["accum"], tx,
                perceptual_net=net.requires_grad_(False), mesh=mesh)
            state = TrainState.create(model)

            def run(batch, draws):
                return step(state, batch, draws=draws)
        batch = d["batch"] if layout == "micro" else \
            block_order(d["batch"], world, d["accum"])
        logs = [{k: float(v) for k, v in run(batch, dr).items()}
                for dr in d["draws"]]
        res[layout] = {"logs": logs, "params": {
            k: v.detach().clone() for k, v in state.params.items()}}
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def block_order(batch: dict, ranks: int, micro: int) -> dict:
    """`batch` with its rows reordered so that the step's layout
    (`shard_batch(..., micro)`: rank r's micro-batch i is block (i, r) of
    the global batch) gives rank r's micro-batch i the rows of block
    (r, i), its i-th slice of the one block `micro` 1 gives it."""
    def order(x):
        if not torch.is_tensor(x) or x.dim() == 0:
            return x
        rest = tuple(x.shape[1:])
        return x.reshape((ranks, micro, -1) + rest).transpose(0, 1) \
            .reshape((-1,) + rest)
    return {k: order(v) for k, v in batch.items()}
