"""VAE training entry point (port of
`gaussiananything_tpu/cli/train_vae.py`):

    python -m gaussiananything_tpu_torch.cli.train_vae --preset vae-release \
        --steps 3 --batch 1 --logdir logs/vae

Trains on seeded random weights and the procedural scenes of
`data/synthetic.py`, on the card unless `--device cpu` is given. The GAN
path, VGG-LPIPS weights, the packed g-buffer dataset, held-out evaluation
and submodule warm starts of the JAX CLI are not ported; their flags are
rejected by the parser.
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None, timers=None):
    """Runs the training loop; returns {"state", "model", "logs" (one dict
    of floats per step)}. `timers`: optional list that receives one
    `StageTimer.seconds` dict per step (each stage then ends in a device
    synchronise)."""
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--preset", default="vae-small")
    p.add_argument("--config", default=None, help="RunConfig json path")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to continue from")
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from gaussiananything_tpu_torch.config import RunConfig, preset
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.logging import MetricLogger
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig,
                                                        restore_checkpoint,
                                                        save_checkpoint)
    from gaussiananything_tpu_torch.train.vae_trainer import (StageTimer,
                                                              VAELossConfig,
                                                              make_train_step)
    from gaussiananything_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    else:
        cfg = preset(args.preset)
    if args.steps:
        cfg.optim.total_steps = args.steps
    if args.batch:
        cfg.optim.batch_size = args.batch
    logdir = args.logdir or os.path.join(cfg.logdir, cfg.name)
    logger = MetricLogger(logdir)
    with open(os.path.join(logdir, "args.json"), "w") as f:
        f.write(cfg.to_json())

    torch.manual_seed(cfg.seed)
    with torch.device(dev):
        model = PointVAE.from_config(cfg.vae, with_encoder=True)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"VAE params: {n_params / 1e6:.2f}M; device: {dev}", flush=True)

    loss_cfg = VAELossConfig(lod_resolutions=cfg.render.lod_resolutions)
    tx_cfg = TrainStateConfig(lr=cfg.optim.lr,
                              weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip,
                              ema_decay=cfg.optim.ema_decay,
                              extra_ema_decays=cfg.optim.extra_ema_decays,
                              warmup_steps=cfg.optim.warmup_steps,
                              lr_mults=cfg.optim.lr_mults)
    step_fn = make_train_step(model, loss_cfg, tx_cfg)
    state = TrainState.create(model, cfg.optim.extra_ema_decays)
    if args.resume:
        restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}", flush=True)

    def batch_at(i: int):
        b = make_batch(seed=cfg.seed + i, batch=cfg.optim.batch_size,
                       n_views_in=cfg.data.n_views_in,
                       n_views_sup=cfg.data.n_views_sup,
                       res=cfg.data.resolution, n_pts=cfg.data.n_points,
                       n_splats=max(512, cfg.data.n_points), device=dev)
        b.pop("gt_gaussians")
        return b

    host_gen = torch.Generator().manual_seed(cfg.seed)
    all_logs = []
    t0 = time.time()
    step0 = state.step
    ckpt_dir = os.path.join(logdir, "ckpt")
    for i in range(state.step, cfg.optim.total_steps):
        timer = StageTimer(dev) if timers is not None else None
        if timer:
            timer.start()
        with torch.no_grad():
            batch = batch_at(i)
        if timer:
            timer.lap("data")
        with logger.profile("g_step"):
            logs = step_fn(state, batch, generator=host_gen, timer=timer)
        logs = {k: float(v) for k, v in logs.items()}
        all_logs.append(logs)
        if timer:
            timers.append(timer.seconds)
        for k, v in logs.items():
            logger.logkv_mean(k, v)
        if (i + 1) % 20 == 0 or i == 0:
            logger.logkv("steps_per_s",
                         (i + 1 - step0) / max(time.time() - t0, 1e-9))
            logger.dumpkvs(i + 1)
        if (i + 1) % args.save_every == 0:
            save_checkpoint(ckpt_dir, state)
    save_checkpoint(ckpt_dir, state)
    logger.close()
    print("done", flush=True)
    return {"state": state, "model": model, "logs": all_logs}


if __name__ == "__main__":
    main()
