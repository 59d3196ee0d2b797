"""The multi-rank dry run: five training steps at tiny widths, each on a
mesh of every rank and against the same step unsharded in each process
(the counterpart of `__graft_entry__.dryrun_multichip`):

1. the full VAE step (encoder → KL → cascaded decoder → multi-LoD 2DGS
   renders → loss stack → optimizer and EMA), data-parallel over every
   rank;
2. the VAE step with the full `vae_loss_fn` (perceptual term, the
   geometry regularisers from step 0) on a data × 2 mesh, the renders in
   row bands over the tile axis;
3. a flow-matching step (stage-1 DiT and conditioner), data-parallel;
4. the VAE step of 1. as gradient accumulation over two micro-batches
   (`make_accum_train_step`), each rank's micro-batch its slice of the
   global one (`shard_batch(..., micro=2)`, inside the step);
5. the flow-matching step of 3. over two micro-batches, laid out alike.

Each sharded step must equal the unsharded one to the JAX package's own
tolerances (`tests/test_sharded_render.py`): `total` (or `fm_loss`)
rtol 1e-5, `grad_norm` rtol 1e-4, each relative to max(1, |unsharded|).

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m gaussiananything_tpu_torch.parallel.dryrun --device cpu \\
        --backend gloo

On the card, `--device cuda` with NCCL when every rank has a card of its
own, or `--backend gloo` to put the ranks on one card. Rank 0 prints one
line `DRYRUN {json}` per phase; every rank prints `DRYRUN-RANK {json}`
with its kernels' launches; a phase out of tolerance raises.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

TOTAL_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
VAE_SIZES = dict(latent_num=16, z_channels=4, encoder_width=64,
                 decoder_width=64, decoder_heads=4, decoder_depth=2,
                 up_factors=(4,), up_depths=(1,), release_parity=False)


def _close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * max(1.0, abs(want))


def _vae_batch(seed, batch, res, device):
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    b = make_batch(seed=seed, batch=batch, n_views_in=2, n_views_sup=2,
                   res=res, n_pts=128, n_splats=256, device=device)
    b.pop("gt_gaussians")
    b.pop("caption", None)
    return b


def vae_step(batch, loss_cfg, mesh, device, seed: int = 0, accum: int = 1):
    """One VAE step from the weights of `seed` on `batch` (the global
    batch, which the step shards over `mesh` when given), over `accum`
    micro-batches; returns its logs as floats."""
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    from gaussiananything_tpu_torch.train.vae_trainer import (
        make_accum_train_step, make_train_step)
    torch.manual_seed(seed)
    with torch.device(device):
        model = PointVAE(with_encoder=True, **VAE_SIZES)
    state = TrainState.create(model)
    tx = TrainStateConfig(lr=1e-4, warmup_steps=1)
    step = make_train_step(model, loss_cfg, tx, mesh=mesh) if accum == 1 \
        else make_accum_train_step(model, loss_cfg, accum, tx, mesh=mesh)
    logs = step(state, batch, generator=torch.Generator().manual_seed(0))
    return {k: float(v) for k, v in logs.items()}


def fm_step(n, mesh, device, seed: int = 0, accum: int = 1):
    """One stage-1 flow-matching step on a global batch of `n`, over
    `accum` micro-batches."""
    from gaussiananything_tpu_torch.diffusion.transport import \
        create_transport
    from gaussiananything_tpu_torch.models.conditioner import \
        ImageConditioner
    from gaussiananything_tpu_torch.models.dit import stage1_dit
    from gaussiananything_tpu_torch.train.fm_trainer import (
        FMConfig, make_fm_train_step)
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    torch.manual_seed(seed)
    with torch.device(device):
        dit = stage1_dit("S", depth=2, width=64, heads=4, cond_dim=32,
                         vector_dim=32)
        cond = ImageConditioner(width=32, depth=1, heads=4, img_size=28,
                                backbone="scratch")
    dit.train()
    cond.train()
    rng = np.random.default_rng(0)
    batch = {"cond": torch.from_numpy(rng.uniform(size=(n, 3, 28, 28))
                                      .astype(np.float32)).to(device),
             "latent": torch.from_numpy(rng.normal(size=(n, 16, 3))
                                        .astype(np.float32)).to(device)}
    step = make_fm_train_step(dit, cond, create_transport("gvp"),
                              FMConfig(stage=1),
                              TrainStateConfig(lr=1e-4, warmup_steps=1),
                              accum=accum, mesh=mesh)
    logs = step(TrainState.create(dit), TrainState.create(cond), batch,
                generator=torch.Generator().manual_seed(1))
    return {k: float(v) for k, v in logs.items()}


def run(device="cpu") -> list:
    """The five phases over every rank of the process group; returns one
    dict per phase (sharded and unsharded `total`/`grad_norm` and whether
    they agree). Raises where a phase does not."""
    from gaussiananything_tpu_torch.parallel.dist import get_world_size
    from gaussiananything_tpu_torch.parallel.mesh import make_mesh
    from gaussiananything_tpu_torch.train.vae_trainer import VAELossConfig
    n = get_world_size()
    results = []

    def record(phase, mesh, got, ref, key):
        rec = {"phase": phase, "mesh": [mesh.data, mesh.tile],
               key: got[key], f"{key}_unsharded": ref[key],
               "grad_norm": got["grad_norm"],
               "grad_norm_unsharded": ref["grad_norm"]}
        rec["ok"] = (_close(got[key], ref[key], TOTAL_RTOL)
                     and _close(got["grad_norm"], ref["grad_norm"],
                                GRAD_NORM_RTOL))
        results.append(rec)
        if not rec["ok"]:
            raise AssertionError(f"dry run phase {phase}: {rec}")

    # ---- phase 1: the full VAE step, data-parallel ------------------------
    mesh = make_mesh(data=n, tile=1)
    cfg = VAELossConfig(lod_resolutions=(16, 32), perceptual_weight=0.0)
    batch = _vae_batch(0, n, 32, device)
    record(1, mesh, vae_step(batch, cfg, mesh, device),
           vae_step(batch, cfg, None, device), "total")

    # ---- phase 2: data × tile, the full loss, row-band renders -------------
    t_sh = 2 if n % 2 == 0 else 1
    mesh2 = make_mesh(data=n // t_sh, tile=t_sh)
    cfg2 = VAELossConfig(lod_resolutions=(32, 64), perceptual_weight=0.5,
                         dist_start_step=0, normal_start_step=0)
    batch2 = _vae_batch(1, n // t_sh, 64, device)
    record(2, mesh2, vae_step(batch2, cfg2, mesh2, device),
           vae_step(batch2, cfg2, None, device), "total")

    # ---- phase 3: a flow-matching step, data-parallel ---------------------
    record(3, mesh, fm_step(n, mesh, device), fm_step(n, None, device),
           "fm_loss")

    # ---- phases 4 and 5: phases 1 and 3 over two micro-batches ------------
    batch4 = _vae_batch(2, 2 * n, 32, device)
    record(4, mesh, vae_step(batch4, cfg, mesh, device, accum=2),
           vae_step(batch4, cfg, None, device, accum=2), "total")
    record(5, mesh, fm_step(2 * n, mesh, device, accum=2),
           fm_step(2 * n, None, device, accum=2), "fm_loss")
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None,
                   help="process-group backend: nccl (default, a card per "
                        "rank) or gloo")
    args = p.parse_args(argv)
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    from gaussiananything_tpu_torch.parallel import dist as pdist
    from gaussiananything_tpu_torch.utils.device import resolve_device
    pdist.setup_dist(args.backend)
    # a check, held at tolerances set in IEEE fp32: under TF32 cuBLAS picks
    # its GEMM by shape, and a rank's micro-batch is not the whole batch
    dev = pdist.rank_device(resolve_device(args.device,
                                           matmul_precision="highest"))
    results = run(dev)
    if pdist.is_main():
        for rec in results:
            print("DRYRUN " + json.dumps(rec), flush=True)
    for r in range(pdist.get_world_size()):     # one rank at a time
        if r == pdist.get_rank():
            print("DRYRUN-RANK " + json.dumps({
                "rank": r, "device": str(dev),
                "launches": {"K1": rc.composite.launches,
                             "K2a": rc.composite_entries.launches,
                             "K2b": rc.composite_backward.launches}}),
                flush=True)
        pdist.synchronize()


if __name__ == "__main__":
    main()
