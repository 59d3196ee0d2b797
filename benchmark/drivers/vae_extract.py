"""Latent extraction in a closed loop with one client: each request is
`cli.extract_latents.extract_instance` on the release VAE, from taking
the instance out of a G-buffer set (`cli.extract_latents.instances`, as
the CLI's `--data-dir` does: `data.gbuffer.MultiViewDataset` batches of
one, world-frame poses, one supervision view, read and decoded ahead
while the last one encodes) to its npz written under TMPDIR, ending in a
synchronise. The set is written from the seed at set-up; each request's
KL noise is drawn from the seed.

Traffic parameters (`benchmark/traffic/<name>.json`):
  instances, views, points_stored   the G-buffer set
  warmup_requests  requests before the window (set-up)
  check_requests   consecutive requests recorded for the check, starting
                   at a request drawn from the seed in [1, check_start_max]

A traced run profiles the first of those requests on the device alone
(its busy seconds over the host clock's window between two synchronises)
and the rest on the host and the device with the benchmark's span (the
breakdown); the program's span recorder (`utils/profiling.recording`) is
on over all of them, and each request's spans' device seconds, summed by
name, go to the record (`spans`).
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import core, inputs, weights
from benchmark.counts import flops
from benchmark.reference import extract as reference
from benchmark.reference import nets

def build(cfg: dict, seed: int, device):
    """The whole VAE as the extraction CLI builds it
    (`PointVAE.from_config(..., with_encoder=True)`), on the meta device,
    then the seeded weights."""
    from gaussiananything_tpu_torch.config import VAEModelConfig
    from gaussiananything_tpu_torch.models.vae import PointVAE
    v = cfg["vae"]
    vcfg = VAEModelConfig(
        latent_num=v["latent_num"], z_channels=v["z_channels"],
        encoder_width=v["encoder_width"], decoder_width=v["decoder_width"],
        decoder_depth=v["decoder_depth"], decoder_heads=v["decoder_heads"],
        up_factors=tuple(v["up_factors"]), up_depths=tuple(v["up_depths"]),
        skip_weight=v["skip_weight"], scale_bias=v["scale_bias"],
        release_parity=True, compute_dtype=cfg["precision"]["compute_dtype"])
    with torch.device("meta"):
        model = PointVAE.from_config(vcfg, with_encoder=True)
        spec = weights.leaves(nets.build("vae", v))
    weights.load(model, weights.make(seed, "vae", spec, device))
    return model.eval()


class Recorder:
    """Keeps what the check reads from the requests it samples: the
    inputs `PointVAE.encode` was given and the posterior and anchors it
    returned (the instance's `encode` wrapped; the program is unchanged)."""

    def __init__(self, model):
        self.on = False
        self.rec: Dict = {}
        encode = model.encode

        def recorded(images, pcd):
            dist, anchors = encode(images, pcd)
            if self.on:
                self.rec.update(images=images, pcd=pcd, mean=dist.mean,
                                logvar=dist.logvar, anchors=anchors)
            return dist, anchors
        model.encode = recorded

    def start(self, draw: int, noise):
        self.rec = {"draw": draw, "noise": noise}
        self.on = True

    def finish(self, arrays) -> dict:
        """The record in host memory, so that the device's peak is the
        program's whichever requests are recorded."""
        self.on = False
        rec = {k: v.to("cpu", copy=True) if torch.is_tensor(v) else v
               for k, v in self.rec.items()}
        rec["z"] = torch.from_numpy(arrays["latent_normalized"])[None]
        return rec


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        t_start: float = None) -> dict:
    # first, so that a program without the extraction path stops at once
    from gaussiananything_tpu_torch.cli.extract_latents import (
        extract_instance, instances)
    from gaussiananything_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)        # the CLI's precision policy
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data_dir = tempfile.mkdtemp(prefix="bench-gbuffer-")
    out_dir = tempfile.mkdtemp(prefix="bench-latents-")
    try:
        files = inputs.write_gbuffer_set(
            data_dir, seed, traffic["instances"], traffic["views"],
            cfg["data"]["resolution"], traffic["points_stored"], dev)
        for path in files:
            # on disk before the window, as a deployment's data set is:
            # its writeback falls into the set-up
            with open(path, "rb") as f:
                os.fsync(f.fileno())
        pick = torch.randint(1, traffic["check_start_max"] + 1, (1,),
                             generator=inputs.generator(seed, 3, "cpu"))
        block = range(int(pick), int(pick) + traffic["check_requests"])
        if control:
            # the reference, one step lower, in the program's place
            recs = [{"draw": traffic["warmup_requests"] + i,
                     "noise": _noise(cfg, seed, i, dev).cpu()}
                    for i in block]
            worst = reference.check(cfg, seed, files, recs, dev,
                                    control=True)
            return core.outcome(cfg, worst, len(recs), 0, 0.0, {})
        return _extract(cfg, traffic, seed, seconds, trace, dev, files,
                        out_dir, block, t_start, extract_instance,
                        instances)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)


def _noise(cfg: dict, seed: int, i: int, dev) -> torch.Tensor:
    """Request i's KL noise (1, K, z); warm-up requests are i < 0."""
    v = cfg["vae"]
    return torch.randn((1, v["latent_num"], v["z_channels"]),
                       generator=inputs.generator(seed, 100 + i, dev),
                       device=dev)


def _extract(cfg, traffic, seed, seconds, trace, dev, files, out_dir, block,
             t_start, extract_instance, instances):
    import numpy as np

    from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
    from gaussiananything_tpu_torch.utils import profiling
    cuda = dev.type == "cuda"
    d = cfg["data"]
    t_built = time.perf_counter()
    model = build(cfg, seed, dev)
    recorder = Recorder(model)
    stream = instances(MultiViewDataset(
        os.path.dirname(files[0]), files=files,
        seed=reference.data_seed(seed), n_views_in=d["n_views_in"],
        n_views_sup=1, n_points=d["n_points"], resolution=d["resolution"],
        device=dev))
    written = [0]

    def one(i):
        t0 = time.perf_counter()
        b = next(stream)
        t1 = time.perf_counter()
        arrays, timings = extract_instance(
            model, b, _noise(cfg, seed, i, dev), d["cond_size"])
        t2 = time.perf_counter()
        path = os.path.join(out_dir, f"{written[0] % 16:05d}.npz")
        np.savez(path, **arrays, caption=np.str_(b["caption"][0]))
        written[0] += 1
        if cuda:
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        # host seconds of the wait for the instance, of
        # `extract_instance` and of the write
        timings.update(data=t1 - t0, extract=t2 - t1, write=t3 - t2)
        return t3 - t0, arrays, timings

    t_warm = time.perf_counter()
    for i in range(traffic["warmup_requests"]):
        one(-1 - i)
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"set-up: to the model (the data set written) "
          f"{t_built - t_start:.2f} s, model and weights "
          f"{t_warm - t_built:.2f} s, warm-up "
          f"{time.perf_counter() - t_warm:.2f} s", file=sys.stderr)

    lat: List[float] = []
    timings: List[Dict[str, float]] = []
    records = []
    prof, span_rec, span_s = None, None, []
    rec_trace: Dict = {}
    recording = contextlib.ExitStack()
    t_setup = time.perf_counter() - t_start
    t_w0, t_w_unix = time.perf_counter(), time.time()
    i = 0
    while time.perf_counter() - t_w0 < seconds or i < block.stop:
        if i in block:
            recorder.start(traffic["warmup_requests"] + i,
                           _noise(cfg, seed, i, dev).cpu())
        if trace and i == block.start:
            span_rec = recording.enter_context(profiling.recording(dev))
            prof, t_i0 = core.device_profile(dev)
        if trace and i == block.start + 1:
            prof = core.start_profile(cuda)
        with core.span(trace and i in block[1:], "bench.request"):
            dt, arrays, tm = one(i)
        lat.append(dt)
        timings.append(tm)
        if trace and i == block.start:
            rec_trace.update(core.busy_window(prof, dev, t_i0))
        if i in block:
            records.append(recorder.finish(arrays))
        if trace and i == block.stop - 1:
            prof.stop()
            span_s = _span_seconds(span_rec)
            recording.close()
        i += 1
    window_s = time.perf_counter() - t_w0
    stream.close()
    p95 = sorted(lat)[math.ceil(0.95 * len(lat)) - 1]
    print(f"window: {window_s:.3f} s from unix time {t_w_unix:.3f}",
          file=sys.stderr)
    print(f"latencies of {len(lat)} requests (p95, nearest rank, "
          f"{p95:.4f} s): " + " ".join(f"{t:.4f}" for t in lat),
          file=sys.stderr)
    print("median host seconds of a request's parts: " + ", ".join(
        f"{k} {statistics.median(t[k] for t in timings):.4f}"
        for k in timings[0]), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del model, recorder, stream
    if cuda:
        torch.cuda.empty_cache()

    if trace:
        dev_ev, host_ev = core.device_intervals(prof)
        req = [h for h in host_ev if h[2] == "bench.request"]
        full = core.reduce_trace(dev_ev, host_ev, req[0][0], req[-1][1])
        rec_trace.update(device_ops=full["device_ops"],
                         idle_gaps=full["idle_gaps"])
    worst = reference.check(cfg, seed, files, records, dev)
    out = core.outcome(cfg, worst, len(lat), peak, window_s, rec_trace)
    out.update(setup_s=t_setup, latencies=lat, timings=timings, spans=span_s,
               flops_per_request=flops.vae_encode(
                   cfg["vae"], 1, d["n_views_in"], d["resolution"]))
    return out


def _span_seconds(recorder) -> List[Dict[str, float]]:
    """Per `ga.extract` span (one a request), the seconds of the spans
    inside it summed by name: device seconds on a card, host seconds on
    the CPU. The spans of the first request, counted by name and
    attributes, go to standard error."""
    spans = recorder.spans()
    out = []
    for k, top in enumerate(s for s in spans if s.name == "ga.extract"):
        inside = [s for s in spans if s.host_end_ns is not None
                  and top.host_start_ns <= s.host_start_ns
                  and s.host_end_ns <= top.host_end_ns]
        sums: Dict[str, float] = collections.defaultdict(float)
        for s in inside:
            sums[s.name] += s.device_s if s.device_s is not None \
                else s.host_s
        out.append(dict(sums))
        if k == 0:
            counts = collections.Counter(
                (s.name, tuple(sorted(s.attrs.items()))) for s in inside)
            print("spans of a request: " + "; ".join(
                f"{name} {dict(attrs) if attrs else ''} x{n}"
                for (name, attrs), n in sorted(counts.items())),
                file=sys.stderr)
    return out
