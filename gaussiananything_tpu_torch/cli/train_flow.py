"""Flow-matching (generator) training entry point (port of
`gaussiananything_tpu/cli/train_flow.py`; the reference's
`scripts/vit_triplane_sit_train.py` under
`shell_scripts/release/train/stage-2-diffusion/*.sh`):

    python -m gaussiananything_tpu_torch.cli.train_flow --preset stage1 \\
        --latent-dir latents/ --freeze-cond --accum 2 --steps 1000 \\
        --save-every 500 --eval-every 500 --logdir logs/flow-s1

Stage 1 denoises the 768×3 FPS xyz (/0.164), stage 2 the 768×10 KL latent
given the xyz; the conditioner is the scratch ViT on a conditioning view
or, with `--cond text`, the byte-token transformer on the captions (or,
with `--bpe VOCAB`, the OpenCLIP text tower on CLIP BPE ids). The data is
the npz latents of `cli/extract_latents.py` (`--latent-dir`, held on the
device: latents, xyz and the conditioning views as uint8) or, without it,
procedural objects whose FPS xyz is the stage-1 target and whose
conditioning view renders through the rasterizer.

Weights start from a random draw of the config's seed (`--dit-ckpt`,
`--cond-ckpt`: a JAX-layout npz or this package's checkpoint directory;
`--resume`: the directory `--save-every` writes, with `<resume>_cond`).
Runs on the card unless `--device cpu` is given (the JAX CLI's
`--platform`). Several GPUs: one process per rank under a launcher
(`python -m torch.distributed.run --nproc_per_node N -m
gaussiananything_tpu_torch.cli.train_flow ...`), on the config's
`mesh_data` × `mesh_tile` mesh as in `cli/train_vae.py` (`--dist-backend`
names a backend other than NCCL). Each rank makes the global batch from
the seed and keeps its data slice, draws the global batch's noise and keeps
its slice; gradients are averaged over the data axis (the tile axis
renders nothing here). Only rank 0 logs, evaluates and writes checkpoints;
every rank draws the evaluation's batch, so the data streams stay one.

Two deliberate differences from the JAX CLI (ADVICE r5):
  * the uint8 cache of the conditioning views rounds (the JAX CLI
    truncates, `cli/train_flow.py:154`), and refuses values outside
    [0, 1];
  * `--resume` continues the data stream where the checkpointed run
    stopped (the JAX CLI restarts it, `:311`): every batch, the evaluation
    batches included, is the same draw of one stream in a straight run
    and in a resumed one, and each step's random draws come from a
    generator seeded by (seed, step).
And one repair: the JAX CLI's `--bpe` builds `ClipBPETokenizer()` without
its required vocabulary path and feeds its ids to the 257-entry byte
embedding; here `--bpe` takes the vocabulary file and selects the OpenCLIP
text tower, whose embedding holds CLIP's 49,408 ids.
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def quantize_cond(cond: np.ndarray) -> np.ndarray:
    """Conditioning views in [0, 1] → uint8, rounded to the nearest 1/255.
    Values more than a float32 rounding (1e-6) outside [0, 1] raise: a
    rendered or resized view never has them."""
    lo, hi = float(cond.min()), float(cond.max())
    if lo < -1e-6 or hi > 1 + 1e-6:
        raise ValueError(f"conditioning views span [{lo}, {hi}], not [0, 1]")
    return np.rint(np.clip(cond, 0.0, 1.0) * 255.0).astype(np.uint8)


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator (the JAX CLI's fold_in)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def main(argv=None, timers=None):
    """Runs the training loop; returns {"state", "cond_state", "dit",
    "cond", "logs" (one dict of floats per step), "evals" (one dict per
    evaluation), "logdir"}. `timers`: optional list that receives one
    `StageTimer.seconds` dict per step (CUDA events on the device's
    stream; one synchronise a step, when the dict is read)."""
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--preset", default="demo-e2e")
    p.add_argument("--config", default=None, help="RunConfig json path")
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--latent-dir", default=None,
                   help="npz latents from cli/extract_latents.py")
    p.add_argument("--cond", default=None, choices=["image", "text"],
                   help="override cfg.dit.cond: 'text' trains on the "
                        "latents' captions")
    p.add_argument("--bpe", default=None, metavar="VOCAB",
                   help="CLIP BPE ids from this bpe_simple_vocab_16e6 file "
                        "and the OpenCLIP text tower; byte ids otherwise")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist-backend", default=None,
                   help="process-group backend of a multi-rank launch: "
                        "nccl (default, a card per rank) or gloo")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation micro-batches per step")
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--freeze-cond", action="store_true",
                   help="freeze the conditioner (no moments, no updates)")
    p.add_argument("--cond-ckpt", default=None,
                   help="initial conditioner weights (npz or checkpoint "
                        "directory)")
    p.add_argument("--dit-ckpt", default=None,
                   help="warm-start DiT weights (npz or checkpoint "
                        "directory)")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory (the --logdir/ckpt that "
                        "--save-every writes) and <resume>_cond")
    p.add_argument("--eval-every", type=int, default=0,
                   help="sample with the EMA weights every N steps: stage 1 "
                        "writes a PLY and logs geometry metrics, stage 2 the "
                        "latent's std and absmax; 0 = off")
    args = p.parse_args(argv)

    import torch
    from torch.func import functional_call

    from gaussiananything_tpu_torch.config import (RunConfig, compute_dtype,
                                                   preset)
    from gaussiananything_tpu_torch.diffusion.transport import \
        create_transport
    from gaussiananything_tpu_torch.models.conditioner import (
        ImageConditioner, TextConditioner, tokenize_bytes)
    from gaussiananything_tpu_torch.models.dit import stage1_dit, stage2_dit
    from gaussiananything_tpu_torch.train.fm_trainer import (
        FMConfig, XYZ_SCALE, make_fm_train_step, make_sampler)
    from gaussiananything_tpu_torch.parallel import dist as pdist
    from gaussiananything_tpu_torch.parallel.mesh import (replicate,
                                                          training_mesh)
    from gaussiananything_tpu_torch.train.logging import (MetricLogger,
                                                          NullLogger)
    from gaussiananything_tpu_torch.train.state import (
        TrainState, TrainStateConfig, restore_checkpoint,
        restore_inference_params, save_checkpoint)
    from gaussiananything_tpu_torch.train.vae_trainer import StageTimer
    from gaussiananything_tpu_torch.utils.device import resolve_device

    pdist.setup_dist(args.dist_backend)
    main_rank = pdist.is_main()
    dev = pdist.rank_device(resolve_device(args.device))
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    else:
        cfg = preset(args.preset)
    cfg.dit.stage = args.stage
    if args.cond:
        cfg.dit.cond = args.cond
    if args.steps:
        cfg.optim.total_steps = args.steps
    if args.batch:
        cfg.optim.batch_size = args.batch
    B = cfg.optim.batch_size
    mesh = training_mesh(cfg.mesh_data, cfg.mesh_tile, B, micro=args.accum)
    logdir = args.logdir or os.path.join(cfg.logdir,
                                         f"{cfg.name}-flow-s{args.stage}")
    logger = MetricLogger(logdir) if main_rank else NullLogger()
    if main_rank:
        with open(os.path.join(logdir, "args.json"), "w") as f:
            f.write(cfg.to_json())

    dtype = compute_dtype(cfg.dit.compute_dtype)
    text_cond = cfg.dit.cond == "text"
    in_ch = 3 if args.stage == 1 else cfg.vae.z_channels
    K = cfg.vae.latent_num
    torch.manual_seed(cfg.seed)
    # remat: per-block recomputation in the backward, as the JAX CLI asks
    dit_kw = dict(size=cfg.dit.size, cond_dim=cfg.dit.cond_width,
                  vector_dim=cfg.dit.cond_width, dtype=dtype, remat=True)
    if args.stage == 2:
        dit_kw["z_channels"] = cfg.vae.z_channels
    with torch.device(dev):
        dit = (stage1_dit if args.stage == 1 else stage2_dit)(**dit_kw)
        if text_cond:
            cond = TextConditioner(
                width=cfg.dit.cond_width, depth=cfg.dit.cond_depth,
                heads=cfg.dit.cond_heads, ucg_rate=cfg.dit.ucg_rate,
                backbone="openclip" if args.bpe else "bytes", dtype=dtype)
        else:
            cond = ImageConditioner(
                width=cfg.dit.cond_width, depth=cfg.dit.cond_depth,
                heads=cfg.dit.cond_heads, img_size=cfg.dit.cond_img_size,
                backbone="scratch", ucg_rate=cfg.dit.ucg_rate, dtype=dtype)
    restore_inference_params(args.cond_ckpt, cond)
    restore_inference_params(args.dit_ckpt, dit)
    replicate(mesh, dit)        # every rank starts from rank 0's weights
    replicate(mesh, cond)
    dit.train()
    cond.train()
    n_params = sum(p.numel() for p in dit.parameters())
    n_cond = sum(p.numel() for p in cond.parameters())
    if main_rank:
        print(f"DiT params: {n_params / 1e6:.2f}M; conditioner "
              f"{n_cond / 1e6:.2f}M"
              f"{' (frozen)' if args.freeze_cond else ''}; device: {dev}; "
              f"mesh {mesh.data} (data) x {mesh.tile} (tile)", flush=True)

    if text_cond:
        if args.bpe:
            from gaussiananything_tpu_torch.models.openclip_text import \
                ClipBPETokenizer
            _tok = ClipBPETokenizer(args.bpe)
        else:
            _tok = tokenize_bytes

        def tokenize(caps):
            return torch.from_numpy(np.asarray(_tok(caps))).long().to(dev)

    # ---------------------------------------------------------------- data
    # One stream of batches from np.random.default_rng(seed), as the JAX
    # CLI draws it; draw 0 is the JAX CLI's init batch (not needed here:
    # its draws are taken, nothing is built). The first `skip` draws only
    # advance the generator, so a resumed run goes on where the
    # checkpointed one stopped.
    if args.latent_dir:
        files = sorted(glob.glob(os.path.join(args.latent_dir, "*.npz")))
        if not files:
            raise FileNotFoundError(f"no npz latents in {args.latent_dir}")
        arrs = [dict(np.load(f)) for f in files]
        # the extracted set is small: held on the device, gathered per step
        lat_all = torch.from_numpy(np.stack(
            [a["latent_normalized"] for a in arrs])).float().to(dev)
        xyz_all = torch.from_numpy(np.stack(
            [a["query_pcd_xyz"] for a in arrs])).float().to(dev)
        caps_all = [str(a.get("caption", "")) for a in arrs]
        cond_all = None if text_cond else torch.from_numpy(quantize_cond(
            np.stack([a["cond"] for a in arrs]))).to(dev)
        del arrs

        def data_iter(rng_np, skip):
            n = 0
            while True:
                idx = rng_np.integers(0, len(files), B)
                n += 1
                if n <= skip:
                    continue
                didx = torch.from_numpy(idx).to(dev)
                b = {"cond": tokenize([caps_all[i] for i in idx])
                     if text_cond else cond_all[didx].float() / 255.0}
                if args.stage == 1:
                    b["latent"] = xyz_all[didx] / XYZ_SCALE
                else:
                    b["latent"] = lat_all[didx]
                    b["xyz"] = xyz_all[didx]
                yield b
    else:
        from gaussiananything_tpu_torch.data.synthetic import (
            describe_object, make_object, render_scene_views)
        from gaussiananything_tpu_torch.ops.fps import sample_farthest_points
        from gaussiananything_tpu_torch.render import cameras

        def data_iter(rng_np, skip):
            n = 0
            while True:
                plan = []
                for _ in range(B):
                    seed = int(rng_np.integers(1 << 30))
                    view = None if text_cond else (rng_np.uniform(-30, 60),
                                                   rng_np.uniform(0, 360))
                    plan.append((seed, view))
                n += 1
                if n <= skip:
                    continue
                lats, conds, caps = [], [], []
                for seed, view in plan:
                    g = make_object(seed, n=512, device=dev)
                    anchors, _ = sample_farthest_points(g[None, :, :3], K)
                    lats.append(anchors[0])
                    if text_cond:
                        caps.append(describe_object(seed))
                    else:
                        pose = cameras.generate_input_camera(1.8, [view])
                        conds.append(render_scene_views(
                            g, pose, cfg.dit.cond_img_size)["image"][0])
                b = {"cond": tokenize(caps) if text_cond
                     else torch.stack(conds),
                     "latent": torch.stack(lats) / XYZ_SCALE}
                if args.stage == 2:
                    b["xyz"] = b["latent"] * XYZ_SCALE
                    b["latent"] = torch.zeros((B, K, in_ch), device=dev)
                yield b

    transport = create_transport(cfg.transport.path_type,
                                 cfg.transport.t_sampler)
    fm_cfg = FMConfig(stage=args.stage, cfg_scale=cfg.transport.cfg_scale,
                      num_steps=cfg.transport.num_steps,
                      sampler=cfg.transport.sampler)
    tx_cfg = TrainStateConfig(lr=cfg.optim.lr,
                              warmup_steps=cfg.optim.warmup_steps,
                              grad_clip=cfg.optim.grad_clip,
                              ema_decay=cfg.optim.ema_decay,
                              extra_ema_decays=cfg.optim.extra_ema_decays,
                              lr_mults=cfg.optim.lr_mults)
    step_fn = make_fm_train_step(dit, cond, transport, fm_cfg, tx_cfg,
                                 accum=args.accum, mesh=mesh)
    state = TrainState.create(dit, cfg.optim.extra_ema_decays)
    cstate = TrainState.create(cond, frozen=args.freeze_cond)
    if args.resume:
        if not os.path.isdir(args.resume + "_cond"):
            raise FileNotFoundError(f"{args.resume}_cond is missing")
        restore_checkpoint(args.resume, state)
        restore_checkpoint(args.resume + "_cond", cstate)
        if main_rank:
            print(f"resumed from {args.resume} at step {state.step}",
                  flush=True)
    start = state.step
    n_evals = start // args.eval_every if args.eval_every else 0
    it = data_iter(np.random.default_rng(cfg.seed), 1 + start + n_evals)

    sampler = None
    evals = []

    def run_eval(step: int):
        """EMA sampling: stage 1 writes a PLY and logs chamfer / EMD /
        F-score against the batch's ground-truth cloud; stage 2 logs the
        latent's moments."""
        nonlocal sampler
        if sampler is None:
            sampler = make_sampler(
                lambda *a, **k: functional_call(dit, state.ema, a, k),
                lambda *a, **k: functional_call(cond, cstate.ema, a, k),
                fm_cfg, latent_shape=(K, in_ch))
        eb = next(it)
        gen = torch.Generator().manual_seed(step_seed(cfg.seed,
                                                      100_000 + step))
        x0 = torch.randn((1, K, in_ch), generator=gen)
        kw = {"xyz": eb["xyz"][:1]} if args.stage == 2 else {}
        cond.eval()                     # no ucg dropout while sampling
        out = sampler(eb["cond"][:1], x0=x0, **kw)
        cond.train()
        os.makedirs(os.path.join(logdir, "eval"), exist_ok=True)
        if args.stage == 1:
            from gaussiananything_tpu_torch.render.ply_io import \
                save_pointcloud_ply
            from gaussiananything_tpu_torch.train.evaluation import \
                geometry_metrics
            xyz = out[0] * XYZ_SCALE
            save_pointcloud_ply(os.path.join(logdir, "eval",
                                             f"sample_{step}.ply"),
                                xyz.cpu().numpy())
            m = geometry_metrics(xyz, eb["latent"][0] * XYZ_SCALE)
        else:
            m = {"latent_std": float(out.std()),
                 "latent_absmax": float(out.abs().max())}
        m = {f"eval_{k}": v for k, v in m.items()}
        for k, v in m.items():
            logger.logkv(k, v)
        evals.append(m)

    all_logs = []
    ckpt_dir = os.path.join(logdir, "ckpt")
    t0 = time.time()
    for i in range(start, cfg.optim.total_steps):
        timer = StageTimer(dev) if timers is not None else None
        if timer:
            timer.start()
        batch = next(it)
        if timer:
            timer.lap("data")
        gen = torch.Generator().manual_seed(step_seed(cfg.seed, i))
        logs = step_fn(state, cstate, batch, generator=gen, timer=timer)
        logs = {k: float(v) for k, v in logs.items()}
        all_logs.append(logs)
        for k, v in logs.items():
            logger.logkv_mean(k, v)
        if args.eval_every and (i + 1) % args.eval_every == 0:
            if timer:
                timer.start()
            if main_rank:
                run_eval(i + 1)
            else:
                next(it)                # the evaluation's draw of the stream
            if timer:
                timer.lap("eval")
        if timer:
            timers.append(timer.seconds)
        if (i + 1) % 20 == 0 or i == 0 or (
                args.eval_every and (i + 1) % args.eval_every == 0):
            logger.logkv("steps_per_s",
                         (i + 1 - start) / max(time.time() - t0, 1e-9))
            logger.dumpkvs(i + 1)
        if (i + 1) % args.save_every == 0 and main_rank:
            save_checkpoint(ckpt_dir, state)
            save_checkpoint(ckpt_dir + "_cond", cstate)
    if main_rank:
        save_checkpoint(ckpt_dir, state)
        save_checkpoint(ckpt_dir + "_cond", cstate)
    logger.close()
    pdist.synchronize()     # no rank leaves before the checkpoint is whole
    if main_rank:
        print("done", flush=True)
    return {"state": state, "cond_state": cstate, "dit": dit, "cond": cond,
            "logs": all_logs, "evals": evals, "logdir": logdir,
            "mesh": mesh}


if __name__ == "__main__":
    main()
