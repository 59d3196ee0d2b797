"""Release VAE training steps back to back: each step is
`train.vae_trainer.make_train_step`'s generator step and, on every second
step, `make_disc_step`'s discriminator step, as `cli/train_vae.py --adv`
composes them, the logs read back to the host as the CLI does. Batches
come from a seeded G-buffer set written at set-up under TMPDIR and read
through `data.gbuffer.MultiViewDataset.iterator`, its prefetch thread
running.

Set-up drives the step from the seed through its first two steps (a
generator step; a generator and a discriminator step) and keeps what the
check reads; the window continues on the same state. It ends after an
even number of steps, so every window holds as many discriminator steps
as half its steps.

A traced run gives three runs of `trace_steps` window steps each to its
readings, one after the other: the device's trace alone (the busy
seconds, over the host clock's window between two synchronises), the
host's and the device's trace with the benchmark's spans (the breakdown)
and CUDA events around each K2a and K2b launch, and `StageTimer`, which
synchronises at each stage. The other steps of the window are timed
plainly, and `train_mfu` reads them.

Traffic parameters (`benchmark/traffic/<name>.json`):
  instances, views, points_stored   the G-buffer set
  trace_steps                       steps in each of a traced run's three
                                    runs (even: a discriminator step in
                                    every second)
"""
from __future__ import annotations

import inspect
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import core, inputs, weights
from benchmark.counts import flops
from benchmark.counts import raster as raster_counts
from benchmark.reference import nets
from benchmark.reference import train as reference

SETUP_STEPS = 2


def build(cfg: dict, seed: int, device):
    """The program's VAE (on the meta device, then the seeded weights),
    VGG-LPIPS and the discriminator with their seeded weights."""
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.losses import (PatchDiscriminator,
                                                         VGGLPIPS)
    v = cfg["vae"]
    dtype = getattr(torch, cfg["precision"]["compute_dtype"])
    with torch.device("meta"):
        model = PointVAE(latent_num=v["latent_num"],
                         z_channels=v["z_channels"],
                         decoder_width=v["decoder_width"],
                         decoder_depth=v["decoder_depth"],
                         decoder_heads=v["decoder_heads"],
                         up_factors=tuple(v["up_factors"]),
                         up_depths=tuple(v["up_depths"]),
                         skip_weight=v["skip_weight"],
                         scale_bias=v["scale_bias"], release_parity=True,
                         with_encoder=True,
                         encoder_width=v["encoder_width"], dtype=dtype)
        spec = weights.leaves(nets.build("vae", v))
    weights.load(model, weights.make(seed, "vae", spec, device))
    with torch.device(device):
        lpips, disc = VGGLPIPS(), PatchDiscriminator()
    for tag, m, ref in (("lpips", lpips, reference.LPIPS),
                        ("disc", disc, reference.PatchDisc)):
        with torch.device("meta"):
            spec = weights.leaves(ref())
        m.load_state_dict(weights.make(seed, tag, spec, device),
                          strict=False)
    return model.train(), lpips.requires_grad_(False), disc


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        t_start: float = None) -> dict:
    from gaussiananything_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)        # the CLI's precision policy
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data_dir = tempfile.mkdtemp(prefix="bench-gbuffer-")
    try:
        files = inputs.write_gbuffer_set(
            data_dir, seed, traffic["instances"], traffic["views"],
            cfg["data"]["resolution"], traffic["points_stored"], dev)
        if control:
            worst = reference.check(cfg, seed, files, None, dev,
                                    control=True)
            return core.outcome(cfg, worst, 0, 0, 0.0, {})
        return _train(cfg, traffic, seed, seconds, trace, dev, files,
                      t_start)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def _train(cfg, traffic, seed, seconds, trace, dev, files, t_start):
    from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    from gaussiananything_tpu_torch.train.vae_trainer import (
        StageTimer, VAELossConfig, make_disc_step, make_train_step)
    cuda = dev.type == "cuda"
    d, o, r, L = cfg["data"], cfg["optim"], cfg["render"], cfg["loss"]
    sd = reference.seeds(seed)
    t_built = time.perf_counter()
    model, lpips, disc = build(cfg, seed, dev)
    tx = TrainStateConfig(lr=o["lr"], weight_decay=o["weight_decay"],
                          grad_clip=o["grad_clip"], ema_decay=o["ema_decay"],
                          warmup_steps=o["warmup_steps"],
                          betas=tuple(o["betas"]))
    loss_cfg = VAELossConfig(
        lod_resolutions=tuple(r["lod_resolutions"]),
        **{k: L[k] for k in (
            "l1_weight", "perceptual_weight", "alpha_weight",
            "depth_weight", "kl_target", "kl_anneal_steps", "normal_weight",
            "normal_start_step", "dist_weight", "dist_start_step",
            "scale_reg_weight", "opacity_reg_weight", "adv_weight",
            "adv_start_step")})
    state = TrainState.create(model)
    dstate = TrainState.create(disc)
    # a job resumed at the optimiser's `start_step`, its moments zero
    state.step = dstate.step = o.get("start_step", 0)
    step_fn = make_train_step(model, loss_cfg, tx, perceptual_net=lpips,
                              disc_model=disc)
    dstep_fn = make_disc_step(model, disc, loss_cfg, tx)
    ds = MultiViewDataset(os.path.dirname(files[0]), files=files,
                          seed=sd["data"], n_views_in=d["n_views_in"],
                          n_views_sup=d["n_views_sup"],
                          n_points=d["n_points"],
                          resolution=d["resolution"], canonicalize=True,
                          device=dev)
    stream = ds.iterator(cfg["batch"])
    gen = torch.Generator().manual_seed(sd["steps"])
    lods_seen: List = []
    recording = {"on": False}
    first: Dict = {}

    def seen_forward(m, a, out):
        if recording["on"]:
            lods_seen.append([g.detach() for g in out["lods"]])
        if not first:
            # the set-up's first forward, for the check, in host memory
            first.update(z=out["z"].detach().to("cpu", copy=True),
                         lods=[g.detach().to("cpu", copy=True)
                               for g in out["lods"]])
    model.register_forward_hook(seen_forward)

    def one(i, timer=None, spans=False):
        t0 = time.perf_counter()
        with core.span(spans, "bench.data"):
            batch = next(stream)
        wait = time.perf_counter() - t0
        batch.pop("caption", None)
        with core.span(spans, "bench.g_step"):
            logs = {k: float(v) for k, v in step_fn(
                state, batch, generator=gen, timer=timer).items()}
        if i % 2 == 1:
            with core.span(spans, "bench.d_step"):
                logs["d_loss"] = float(dstep_fn(dstate, batch,
                                                generator=gen)["d_loss"])
        return logs, wait, batch

    t_steps = time.perf_counter()
    try:
        # what the check reads waits in host memory: the device's peak
        # stays the program's
        p0 = {k: p.detach().to("cpu", copy=True)
              for k, p in state.params.items()}
        seen = {"losses": []}
        for i in range(SETUP_STEPS):
            logs, _, _ = one(i)
            seen["losses"].append(logs["total"])
            if i == 0:
                seen["mu1"] = {k: m.to("cpu", copy=True)
                               for k, m in state.mu.items()}
            if "d_loss" in logs:
                seen["d_loss"] = logs["d_loss"]
        seen["delta"] = {k: p.detach().cpu() - p0[k]
                         for k, p in state.params.items()}
        seen["first"] = first
        del p0
        if cuda:
            torch.cuda.synchronize(dev)
        print(f"set-up: to the models (the data set written) "
              f"{t_built - t_start:.2f} s, models, weights and state "
              f"{t_steps - t_built:.2f} s, two steps "
              f"{time.perf_counter() - t_steps:.2f} s", file=sys.stderr)

        k2_events: List = []
        k2_sizes: List = []
        stage_s: List[Dict[str, float]] = []
        waits: List[float] = []
        plain_s: List[float] = []
        traced_views = []
        prof = None
        rec_trace: Dict = {}
        n = traffic["trace_steps"]
        idle = range(SETUP_STEPS + 1, SETUP_STEPS + 1 + n)
        full = range(idle.stop, idle.stop + n)
        timed = range(full.stop, full.stop + n) if trace else range(0)
        if not trace:
            idle = full = range(0)
        t_setup = time.perf_counter() - t_start
        t_w0, t_w_unix = time.perf_counter(), time.time()
        i = SETUP_STEPS
        while time.perf_counter() - t_w0 < seconds \
                or (i - SETUP_STEPS) % 2 or i < timed.stop:
            if i == idle.start:
                prof, t_i0 = core.device_profile(dev)
            if i == full.start:
                prof = core.start_profile(cuda)
                if cuda:
                    rasterize_cuda.event_log = k2_events
                    _size_k2(rasterize_cuda, k2_sizes)
                recording["on"] = True
            timer = StageTimer(dev) if i in timed else None
            t0 = time.perf_counter()
            logs, wait, batch = one(i, timer, spans=i in full)
            if not (i in idle or i in full or i in timed):
                plain_s.append(time.perf_counter() - t0)
            waits.append(wait)
            if timer is not None:
                stage_s.append(timer.seconds)
            if i in full:
                traced_views.append((lods_seen[-1 if i % 2 == 0 else -2],
                                     batch["cam_view"],
                                     batch["cam_view_proj"]))
            if i == idle.stop - 1:
                rec_trace.update(core.busy_window(prof, dev, t_i0))
            if i == full.stop - 1:
                recording["on"] = False
                rasterize_cuda.event_log = None
                if cuda:
                    _size_k2(rasterize_cuda, None)
                prof.stop()
            del batch
            i += 1
        window_s = time.perf_counter() - t_w0
        n_steps = i - SETUP_STEPS
        print(f"window: {window_s:.3f} s from unix time {t_w_unix:.3f}, "
              f"{n_steps} steps; steps timed plainly (s): "
              + " ".join(f"{t:.4f}" for t in plain_s), file=sys.stderr)
    finally:
        stream.close()
        if cuda:
            _size_k2(rasterize_cuda, None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state, dstate, model, disc, lpips, step_fn, dstep_fn, lods_seen
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        dev_ev, host_ev = core.device_intervals(prof)
        steps_ = [h for h in host_ev if h[2] in ("bench.data",
                                                 "bench.g_step",
                                                 "bench.d_step")]
        full_trace = core.reduce_trace(dev_ev, host_ev, steps_[0][0],
                                       steps_[-1][1])
        rec_trace.update(device_ops=full_trace["device_ops"],
                         idle_gaps=full_trace["idle_gaps"])
        rec_trace["k2"] = [(name, size, a.elapsed_time(b) / 1e3)
                           for (name, a, b), size in zip(k2_events, k2_sizes)
                           if name in ("K2a", "K2b")]
    worst = reference.check(cfg, seed, files, seen, dev)
    out = core.outcome(cfg, worst, n_steps, peak, window_s, rec_trace)
    out.update(setup_s=t_setup, train_steps=n_steps, data_wait=waits,
               stage_s=stage_s, plain_step_s=plain_s,
               flops_per_step=flops.train_step(cfg))
    if traced_views:
        out["k2_bounds"] = _k2_bounds(cfg, traced_views)
    return out


def _size_k2(rasterize_cuda, sizes):
    """While `sizes` is a list, each K2a and K2b launch appends its image
    height, in launch order (as `event_log` appends its events)."""
    for name in ("composite_entries", "composite_backward"):
        cur = getattr(rasterize_cuda, name)
        fn = getattr(cur, "__wrapped__", cur)
        if cur is not fn:       # the wrapper's name counted the launches
            fn.launches = cur.launches
        if sizes is None:
            setattr(rasterize_cuda, name, fn)
            continue
        sig = inspect.signature(fn)

        def sized(*a, fn=fn, sig=sig, **kw):
            sizes.append(int(sig.bind(*a, **kw).arguments["img_h"]))
            return fn(*a, **kw)
        sized.__wrapped__, sized.launches = fn, fn.launches
        setattr(rasterize_cuda, name, sized)


def _k2_bounds(cfg, traced) -> Dict[str, Dict[int, dict]]:
    """The work of the traced steps' training renders per launch: for each
    kernel ("K2a" the forward, "K2b" the backward) and LoD resolution, the
    mean over the views rendered there of a view's operations, bytes and
    bound seconds. Each render of a LoD renders all its views, so a
    launch's bound is its LoD's mean."""
    from benchmark.reference import raster
    r = cfg["render"]
    per: Dict[str, Dict[int, List[dict]]] = {"K2a": {}, "K2b": {}}
    with torch.no_grad():
        for lods, cv, cvp in traced:
            B, V = cv.shape[:2]
            for g, res in zip(lods, r["lod_resolutions"]):
                for b in range(B):
                    for v in range(V):
                        _, w = raster.rasterize(
                            g[b].detach().float(), cv[b, v].float(),
                            cvp[b, v], torch.ones(3, device=g.device), res,
                            r["tile"], r["max_per_tile"], r["chunk"])
                        n = g.shape[1]
                        per["K2a"].setdefault(res, []).append(
                            raster_counts.forward_view(w["steps"], n, res,
                                                       r["tile"]))
                        per["K2b"].setdefault(res, []).append(
                            raster_counts.backward_view(
                                w["steps"], w["blended"], n, res,
                                r["tile"]))
    return {k: {res: raster_counts.mean_view(vs) for res, vs in d.items()}
            for k, d in per.items()}
