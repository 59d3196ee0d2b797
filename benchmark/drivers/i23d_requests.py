"""Image-to-3D requests in a closed loop with one client: each request is
`cli.sample.sample_request` on the cascade's modules, with its own seeded
conditioning image and noise, complete once the final LoD's gaussians and
the turntable are in host memory.

Traffic parameters (`benchmark/traffic/<name>.json`):
  image_pool       distinct conditioning images, used in turn
  warmup_requests  requests before the window (set-up)
  check_requests   consecutive requests recorded for the check, starting
                   at a request drawn from the seed in [1, check_start_max]

A traced run profiles the first of those requests on the device alone
(its busy seconds over the host clock's window between two synchronises)
and the rest on the host and the device with the benchmark's spans (the
breakdown); CUDA events time each K1 launch in all of them.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List

import torch

from benchmark import core, inputs, weights
from benchmark.counts import flops
from benchmark.counts import raster as raster_counts
from benchmark.reference import i23d as reference
from benchmark.reference import nets


def build(cfg: dict, seed: int, device):
    """The program's cascade from the configuration, on the meta device,
    then the seeded weights (no init of its own, no copy)."""
    from gaussiananything_tpu_torch.cli.sample import ReleaseModels
    from gaussiananything_tpu_torch.models.conditioner import \
        ImageConditioner
    from gaussiananything_tpu_torch.models.dit import PointDiT
    from gaussiananything_tpu_torch.models.vae import PointVAE
    dtype = getattr(torch, cfg["precision"]["compute_dtype"])
    c, v = cfg["conditioner"], cfg["vae"]
    with torch.device("meta"):
        cond = ImageConditioner(width=c["width"], depth=c["depth"],
                                heads=c["heads"], img_size=c["img_size"],
                                backbone="dinov2", dtype=dtype)

        def dit(d):
            return PointDiT(in_channels=d["in_channels"], width=d["width"],
                            depth=d["depth"], heads=d["heads"],
                            cond_dim=d["cond_dim"],
                            vector_dim=d["vector_dim"],
                            use_xyz_pe=d["in_channels"] != 3,
                            release_parity=True, variant="clay", dtype=dtype)
        dit1, dit2 = dit(cfg["dit1"]), dit(cfg["dit2"])
        vae = PointVAE(latent_num=v["latent_num"], z_channels=v["z_channels"],
                       decoder_width=v["decoder_width"],
                       decoder_depth=v["decoder_depth"],
                       decoder_heads=v["decoder_heads"],
                       up_factors=tuple(v["up_factors"]),
                       up_depths=tuple(v["up_depths"]),
                       skip_weight=v["skip_weight"],
                       scale_bias=v["scale_bias"], release_parity=True,
                       with_encoder=False, dtype=dtype)
    kinds = {"cond": "conditioner", "dit1": "dit", "dit2": "dit",
             "vae": "vae_decoder"}
    mods = {"cond": cond, "dit1": dit1, "dit2": dit2, "vae": vae}
    for tag, m in mods.items():
        with torch.device("meta"):
            spec = weights.leaves(nets.build(kinds[tag], cfg[
                {"cond": "conditioner"}.get(tag, tag)]))
        weights.load(m, weights.make(seed, tag, spec, device))
        m.eval()
    return ReleaseModels(cond=cond, dit1=dit1, dit2=dit2, vae=vae,
                         xyz_cond_scale=reference.XYZ_COND,
                         latent_num=v["latent_num"])


class Recorder:
    """Forward hooks that keep what the check reads from the requests it
    samples: the conditioner's output, each DiT call's input (the cond
    half of the CFG batch), stage 2's points."""

    def __init__(self, models):
        self.on = False
        self.rec: Dict = {}
        models.cond.register_forward_hook(self._cond)
        for k, m in ((0, models.dit1), (1, models.dit2)):
            m.register_forward_pre_hook(self._dit(k), with_kwargs=True)

    def start(self, image, x0):
        self.rec = {"image": image, "x0": x0,
                    "stages": [{"calls": []}, {"calls": []}]}
        self.on = True

    def _cond(self, module, args, out):
        if self.on and "tokens" not in self.rec:
            self.rec["tokens"] = out.crossattn[:1].clone()
            self.rec["vector"] = out.vector[:1].clone()

    def _dit(self, k):
        def hook(module, args, kwargs):
            if self.on:
                self.rec["stages"][k]["calls"].append(args[0][:1].clone())
        return hook

    def finish(self, out) -> dict:
        self.on = False
        rec = self.rec
        for k, final in enumerate((out["xyz_n"], out["kl"])):
            calls = rec["stages"][k].pop("calls")
            rec["stages"][k].update(x=calls[0::2], mid=calls[1::2],
                                    final=final.clone())
        # the outputs wait for the check in host memory, so that the
        # device's peak is the program's whichever requests are recorded
        rec["lods"] = [g.to("cpu", copy=True) for g in out["lods"]]
        rec["render"] = {k: v.to("cpu", copy=True)
                         for k, v in out["render"].items()}
        return rec


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        t_start: float = None) -> dict:
    from gaussiananything_tpu_torch.cli import sample
    from gaussiananything_tpu_torch.config import RenderConfig
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
    from gaussiananything_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)        # the CLI's precision policy
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    s, r = cfg["sampler"], cfg["render"]
    fm1 = FMConfig(stage=1, cfg_scale=s["cfg_scale"],
                   num_steps=s["num_steps"], sampler=s["method"])
    fm2 = dataclasses.replace(fm1, stage=2)
    rcfg = RenderConfig(output_size=r["output_size"], tile=r["tile"],
                        max_per_tile=r["max_per_tile"], chunk=r["chunk"])
    K = cfg["vae"]["latent_num"]
    n_img = traffic["image_pool"]
    images = inputs.object_images(
        n_img, cfg["conditioner"]["img_size"],
        inputs.generator(seed, 1, dev), dev)
    check_n = traffic["check_requests"]
    pick = torch.randint(1, traffic["check_start_max"] + 1, (1,),
                         generator=inputs.generator(seed, 3, "cpu"))
    first = int(pick)
    block = range(first, first + check_n)

    def inputs_of(i):
        g = inputs.generator(seed, 100 + i, dev)
        return (images[i % n_img][None],
                (torch.randn((1, K, 3), generator=g, device=dev),
                 torch.randn((1, K, cfg["dit2"]["in_channels"]), generator=g,
                             device=dev)))
    if control:
        # the reference, one step lower, in the program's place
        recs = [dict(zip(("image", "x0"), inputs_of(i))) for i in block]
        worst, _ = reference.check(cfg, seed, recs, dev, control=True)
        return core.outcome(cfg, worst, len(recs), 0, 0.0, {})

    t_built = time.perf_counter()
    models = build(cfg, seed, dev)
    recorder = Recorder(models)
    if trace:
        for name in ("cond", "dit1", "dit2"):
            _annotate(getattr(models, name), "bench." + name)

    def one(i):
        image, x0 = inputs_of(i)
        t0 = time.perf_counter()
        out = sample.sample_request(models, image, fm1, fm2, rcfg, None,
                                    x0_stage1=x0[0], x0_stage2=x0[1],
                                    log=lambda _: None)
        # complete once the final LoD and the turntable are in host memory
        out["lods"][-1].to("cpu")
        for v in out["render"].values():
            v.to("cpu")
        return time.perf_counter() - t0, out

    t_warm = time.perf_counter()
    for i in range(traffic["warmup_requests"]):
        one(-1 - i)
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"set-up: to the models {t_built - t_start:.2f} s, models and "
          f"weights {t_warm - t_built:.2f} s, warm-up "
          f"{time.perf_counter() - t_warm:.2f} s", file=sys.stderr)

    lat: List[float] = []
    timings: List[Dict[str, float]] = []
    records, k1_events = [], []
    prof = None
    rec_trace: Dict = {}
    t_setup = time.perf_counter() - t_start
    t_w0, t_w_unix = time.perf_counter(), time.time()
    i = 0
    while time.perf_counter() - t_w0 < seconds or i < block.stop:
        if i in block:
            recorder.start(*inputs_of(i))
        if trace and i == block.start:
            if cuda:
                rasterize_cuda.event_log = k1_events
            prof, t_i0 = core.device_profile(dev)
        if trace and i == block.start + 1:
            prof = core.start_profile(cuda)
        with core.span(trace and i in block[1:], "bench.request"):
            dt, out = one(i)
        lat.append(dt)
        timings.append(dict(out["timings"]))
        if i in block:
            records.append(recorder.finish(out))
        if trace and i == block.start:
            rec_trace.update(core.busy_window(prof, dev, t_i0))
        if trace and i == block.stop - 1:
            rasterize_cuda.event_log = None
            prof.stop()
        del out
        i += 1
    window_s = time.perf_counter() - t_w0
    p95 = sorted(lat)[math.ceil(0.95 * len(lat)) - 1]
    print(f"window: {window_s:.3f} s from unix time {t_w_unix:.3f}",
          file=sys.stderr)
    print(f"latencies of {len(lat)} requests (p95, nearest rank, "
          f"{p95:.4f} s): " + " ".join(f"{t:.4f}" for t in lat),
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del models, recorder
    if cuda:
        torch.cuda.empty_cache()

    if trace:
        dev_ev, host_ev = core.device_intervals(prof)
        req = [h for h in host_ev if h[2] == "bench.request"]
        full = core.reduce_trace(dev_ev, host_ev, req[0][0], req[-1][1])
        rec_trace.update(device_ops=full["device_ops"],
                         idle_gaps=full["idle_gaps"])
        rec_trace["k1_s"] = [a.elapsed_time(b) / 1e3 for n, a, b in
                             k1_events if n == "K1"]
    worst, steps = reference.check(cfg, seed, records, dev)
    out = core.outcome(cfg, worst, len(lat), peak, window_s, rec_trace)
    out.update(setup_s=t_setup, latencies=lat, timings=timings,
               flops_per_request=flops.request(cfg),
               views=r["turntable_views"])
    if trace and steps:
        n = records[0]["lods"][-1].shape[1]
        out["k1_bounds"] = [raster_counts.forward_view(
            v, n, r["output_size"], r["tile"]) for st in steps for v in st]
    return out


def _annotate(module, name):
    """A profiler span around each forward of `module`."""
    open_ = []

    def pre(m, args):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        open_.append(rf)

    def post(m, args, out):
        open_.pop().__exit__(None, None, None)

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)
