"""VAE training entry point (port of
`gaussiananything_tpu/cli/train_vae.py`; the reference's
`scripts/vit_triplane_train.py` under
`shell_scripts/release/train/stage-1-vae3d/vae3d-adv-512.sh`):

    python -m gaussiananything_tpu_torch.cli.train_vae --preset vae-release \
        --adv --lpips-npz lpips_vgg.npz --data-dir data/ --holdout 1 \
        --canonicalize --eval-every 500 --steps 1000 --batch 2 \
        --logdir logs/vae

Weights start from a random draw of the config's seed (or `--resume`, or
a grafted submodule); the data is the packed g-buffer dataset of `--data-dir`
(`data/gbuffer.py`), else procedural scenes (`data/synthetic.py`). Runs on
the card unless `--device cpu` is given; the JAX CLI's `--platform` is
`--device` here.

Several GPUs: start one process per rank with a launcher,

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m gaussiananything_tpu_torch.cli.train_vae --config run.json ...

The mesh is the config's `mesh_data` × `mesh_tile` (data = mesh_data or
gcd(batch, world // mesh_tile)); a world size other than data × tile is
refused. Each rank makes the global batch from the seed and keeps its data
slice; the tile axis renders each view in row bands. The backend is NCCL
(a card per rank) unless `--dist-backend` names another (gloo runs several
ranks on one card). Only rank 0 logs, evaluates and writes checkpoints;
`--resume` restores on every rank.
"""
from __future__ import annotations

import argparse
import glob
import os
import time


def main(argv=None, timers=None):
    """Runs the training loop; returns {"state", "model", "logs" (one dict
    of floats per step), "disc_state" (None without `--adv`), "d_logs"
    and "evals" (one dict of floats per discriminator step and per
    evaluation)}. `timers`: optional list that receives one
    `StageTimer.seconds` dict per step (each stage then ends in a device
    synchronise)."""
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--preset", default="vae-small")
    p.add_argument("--config", default=None, help="RunConfig json path")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--adv", action="store_true",
                   help="PatchGAN: adversarial weight 0.05, discriminator "
                        "steps on odd steps")
    p.add_argument("--adv-start", type=int, default=0,
                   help="step from which the generator's adversarial term "
                        "counts")
    p.add_argument("--lpips-npz", default=None,
                   help="VGG-LPIPS weights in the JAX package's npz layout "
                        "(its save_params_npz of convert_lpips_vgg); "
                        "default: the seeded pyramid")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to continue from (and "
                        "<resume>_disc for the discriminator)")
    p.add_argument("--load-submodule", default=None, metavar="NAME=CKPT",
                   help="warm start: graft one top-level submodule (e.g. "
                        "encoder=/path/to/ckpt) from a checkpoint")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--dist-backend", default=None,
                   help="process-group backend of a multi-rank launch: "
                        "nccl (default, a card per rank) or gloo")
    p.add_argument("--data-dir", default=None,
                   help="packed g-buffer npz dataset; procedural scenes "
                        "otherwise")
    p.add_argument("--canonicalize", action="store_true",
                   help="frame-0-as-canonical rebase of each sample's poses "
                        "and point cloud")
    p.add_argument("--holdout", type=int, default=0,
                   help="with --data-dir: the LAST N instances are never "
                        "trained on; each evaluation reports on one fixed "
                        "batch of min(N, 4) of them")
    args = p.parse_args(argv)

    import torch

    from gaussiananything_tpu_torch.config import RunConfig, preset
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.parallel import dist as pdist
    from gaussiananything_tpu_torch.parallel.mesh import (replicate,
                                                          training_mesh)
    from gaussiananything_tpu_torch.train.evaluation import eval_novelview
    from gaussiananything_tpu_torch.train.logging import (MetricLogger,
                                                          NullLogger)
    from gaussiananything_tpu_torch.train.losses import PatchDiscriminator
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig,
                                                        load_submodule,
                                                        restore_checkpoint,
                                                        save_checkpoint)
    from gaussiananything_tpu_torch.train.vae_trainer import (StageTimer,
                                                              VAELossConfig,
                                                              make_disc_step,
                                                              make_train_step)
    from gaussiananything_tpu_torch.utils.device import resolve_device

    pdist.setup_dist(args.dist_backend)
    main_rank = pdist.is_main()
    dev = pdist.rank_device(resolve_device(args.device))
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    else:
        cfg = preset(args.preset)
    if args.steps:
        cfg.optim.total_steps = args.steps
    if args.batch:
        cfg.optim.batch_size = args.batch
    mesh = training_mesh(cfg.mesh_data, cfg.mesh_tile, cfg.optim.batch_size)
    logdir = args.logdir or os.path.join(cfg.logdir, cfg.name)
    logger = MetricLogger(logdir) if main_rank else NullLogger()
    if main_rank:
        with open(os.path.join(logdir, "args.json"), "w") as f:
            f.write(cfg.to_json())

    torch.manual_seed(cfg.seed)
    with torch.device(dev):
        model = PointVAE.from_config(cfg.vae, with_encoder=True)
    model.train()
    replicate(mesh, model)      # every rank starts from rank 0's weights
    n_params = sum(p.numel() for p in model.parameters())
    if main_rank:
        print(f"VAE params: {n_params / 1e6:.2f}M; device: {dev}; mesh "
              f"{mesh.data} (data) x {mesh.tile} (tile)", flush=True)

    eval_batch_fixed = stream = None
    if args.data_dir:
        from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
        files = sorted(glob.glob(os.path.join(args.data_dir, "*.npz")))
        if len(files) <= args.holdout:
            raise ValueError(f"{len(files)} instances under {args.data_dir} "
                             f"leave none to train on beside "
                             f"--holdout {args.holdout}")
        split = len(files) - args.holdout
        data_kw = dict(n_views_in=cfg.data.n_views_in,
                       n_views_sup=cfg.data.n_views_sup,
                       n_points=cfg.data.n_points,
                       resolution=cfg.data.resolution,
                       canonicalize=args.canonicalize, device=dev)
        train_ds = MultiViewDataset(args.data_dir, files=files[:split],
                                    seed=cfg.seed, **data_kw)
        if main_rank:
            print(f"dataset: {split} train / {args.holdout} held-out "
                  f"instances", flush=True)
        stream = train_ds.iterator(cfg.optim.batch_size)

        def next_batch(i: int):
            return next(stream)

        if args.holdout:
            # the SAME held-out batch at every evaluation: a clean PSNR /
            # SSIM trajectory on instances the optimiser never sees
            eval_batch_fixed = MultiViewDataset(
                args.data_dir, files=files[split:], seed=12345,
                **data_kw).batch(min(args.holdout, 4))
    else:
        def next_batch(i: int):
            b = make_batch(seed=cfg.seed + i, batch=cfg.optim.batch_size,
                           n_views_in=cfg.data.n_views_in,
                           n_views_sup=cfg.data.n_views_sup,
                           res=cfg.data.resolution, n_pts=cfg.data.n_points,
                           n_splats=max(512, cfg.data.n_points), device=dev)
            b.pop("gt_gaussians")
            return b

    loss_cfg = VAELossConfig(lod_resolutions=cfg.render.lod_resolutions,
                             adv_weight=0.05 if args.adv else 0.0,
                             adv_start_step=args.adv_start)
    lpips_net = None
    if args.lpips_npz:
        from gaussiananything_tpu_torch.train.losses import VGGLPIPS
        from gaussiananything_tpu_torch.utils.param_io import (
            from_jax_params, load_params_npz)
        lpips_net = VGGLPIPS()
        lpips_net.load_state_dict(from_jax_params(
            load_params_npz(args.lpips_npz), lpips_net))
        lpips_net = lpips_net.to(dev).requires_grad_(False)
        if main_rank:
            print(f"loaded VGG-LPIPS weights from {args.lpips_npz}",
                  flush=True)
    tx_cfg = TrainStateConfig(lr=cfg.optim.lr,
                              weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip,
                              ema_decay=cfg.optim.ema_decay,
                              extra_ema_decays=cfg.optim.extra_ema_decays,
                              warmup_steps=cfg.optim.warmup_steps,
                              lr_mults=cfg.optim.lr_mults)
    state = TrainState.create(model, cfg.optim.extra_ema_decays)
    if args.resume:
        restore_checkpoint(args.resume, state)
        if main_rank:
            print(f"resumed from {args.resume} at step {state.step}",
                  flush=True)
    if args.load_submodule:
        name, _, ckpt = args.load_submodule.partition("=")
        load_submodule(ckpt, state, name)
        if main_rank:
            print(f"grafted submodule {name!r} from {ckpt}", flush=True)

    disc = dstate = dstep_fn = None
    if args.adv:
        with torch.device(dev):
            disc = PatchDiscriminator()
        replicate(mesh, disc)
        dstate = TrainState.create(disc)
        dstep_fn = make_disc_step(model, disc, loss_cfg, tx_cfg, mesh=mesh)
        # the discriminator's checkpoint (`nsr/train_nv_util.py:1637-1692`)
        if args.resume and os.path.isdir(args.resume + "_disc"):
            restore_checkpoint(args.resume + "_disc", dstate)
            print(f"resumed discriminator at step {dstate.step}",
                  flush=True)
    step_fn = make_train_step(model, loss_cfg, tx_cfg,
                              perceptual_net=lpips_net, disc_model=disc,
                              mesh=mesh)

    host_gen = torch.Generator().manual_seed(cfg.seed)
    all_logs, d_logs, evals = [], [], []
    t0 = time.time()
    step0 = state.step
    ckpt_dir = os.path.join(logdir, "ckpt")
    try:
        for i in range(state.step, cfg.optim.total_steps):
            timer = StageTimer(dev) if timers is not None else None
            if timer:
                timer.start()
            batch = next_batch(i)
            batch.pop("caption", None)
            if timer:
                timer.lap("data")
            with logger.profile("g_step"):
                logs = step_fn(state, batch, generator=host_gen,
                               timer=timer)
            logs = {k: float(v) for k, v in logs.items()}
            all_logs.append(logs)
            for k, v in logs.items():
                logger.logkv_mean(k, v)
            if args.adv and i % 2 == 1:   # alternate d-steps (`:2933-2948`)
                if timer:
                    timer.start()
                with logger.profile("d_step"):
                    dl = dstep_fn(dstate, batch, generator=host_gen)
                dl = {k: float(v) for k, v in dl.items()}
                if timer:
                    timer.lap("disc_step")
                d_logs.append(dl)
                logger.logkv_mean("d_loss", dl["d_loss"])
            if (i + 1) % args.eval_every == 0:
                if timer:
                    timer.start()
                eval_batch = eval_batch_fixed
                if eval_batch is None:      # every rank: one data stream
                    with torch.no_grad():
                        eval_batch = next_batch(i + 1)
                if main_rank:
                    m = eval_novelview(model, state.ema, eval_batch,
                                       loss_cfg.lod_resolutions,
                                       out_dir=os.path.join(logdir, "eval"),
                                       step=i + 1, generator=host_gen)
                    evals.append(m)
                    for k, v in m.items():
                        logger.logkv(k, v)
                # the evaluation drew from rank 0's generator
                pdist.broadcast_generator(host_gen, batch["pcd"].device)
                if timer:
                    timer.lap("eval")
                logger.dumpkvs(i + 1)
            if timer:
                timers.append(timer.seconds)
            if ((i + 1) % 20 == 0 or i == 0) and (i + 1) % args.eval_every:
                logger.logkv("steps_per_s",
                             (i + 1 - step0) / max(time.time() - t0, 1e-9))
                logger.dumpkvs(i + 1)
            if (i + 1) % args.save_every == 0 and main_rank:
                save_checkpoint(ckpt_dir, state)
                if dstate is not None:
                    save_checkpoint(ckpt_dir + "_disc", dstate)
    finally:
        if stream is not None:
            stream.close()     # stops the prefetch thread
    if main_rank:
        save_checkpoint(ckpt_dir, state)
        if dstate is not None:
            save_checkpoint(ckpt_dir + "_disc", dstate)
    logger.close()
    pdist.synchronize()     # no rank leaves before the checkpoint is whole
    if main_rank:
        print("done", flush=True)
    return {"state": state, "model": model, "logs": all_logs,
            "disc_state": dstate, "d_logs": d_logs, "evals": evals,
            "mesh": mesh}


if __name__ == "__main__":
    main()
