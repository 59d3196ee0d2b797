"""The spans of release image-to-3D requests on one card: what
`utils/profiling.recording` reads inside a request, and what it costs.

    python3 tools/request_spans.py --seed <n> [--requests 12] \\
        [--out request_spans.json]

from the root of a checkout, on a CUDA card. It builds the benchmark's
`i23d-release` cascade with its seeded weights and inputs
(`benchmark/drivers/i23d_requests.build`), warms up, then runs
`--requests` requests with the recorder off and as many with it on, in
the order off, on, on, off (each request complete once its final LoD and
turntable are in host memory, as the benchmark's), then one request under
a device-only `torch.profiler` run and one under a host-and-device run,
both recorded. It prints one JSON line and writes it to `--out`:

  latency_s            median latency with the recorder off and on
  span_cost_us         host µs of one empty span with the recorder on
                       (2,000 in a row)
  cond_s               per request, the device seconds of its two
                       `ga.condition` spans (median over recorded requests)
  dit_eval_ms          median device ms of a `ga.velocity` span (host ms
                       beside)
  dit_busy_ms          median over the device-profiled request's
                       `ga.velocity` spans of the union of the device ops
                       inside each span's device interval
  dit_graphs           per recorded request, its `ga.dit.replay` and
                       `ga.dit.capture` counts and the share of its
                       `ga.velocity` evaluations that replayed a CUDA graph
  idle_share_plain     1 - (device-busy inside the profiled request's
                       `ga.request` interval) / (median device seconds of
                       `ga.request` over the recorded requests), in %
  launches_request     device ops inside that interval
  project_ms, bin_ms,  median device ms of `ga.render.project` and
  k1_ms                `ga.render.bin` in the views that ran them eagerly
                       (a view that replays a graph opens neither; one
                       that captures opens both, with no device time),
                       and of `ga.kernel.K1`
  replay_ms            median device ms of `ga.render.replay`: a view's
                       projection and binning replayed as one CUDA graph,
                       the copies of its inputs excluded
  render_graphs        per recorded request, its `ga.render.replay` and
                       `ga.render.capture` counts and the share of its
                       `ga.render.view` spans that replayed a graph
  rownorm              the row-norm kernel (`ops/rownorm`): per recorded
                       request its `ga.kernel.rownorm` spans (eager
                       launches; a DiT graph's replays open none); in the
                       device-profiled request its kernels inside
                       `ga.request` and inside the `ga.velocity` spans,
                       beside the mean reductions there (one a plain
                       norm); and the norms on the card that took the
                       kernel or stayed plain (`rownorm.plain`, by
                       reason), inside the DiT forwards (their eager and
                       capturing calls, over the warm-up and the recorded
                       requests) and elsewhere
  accounts             per recorded request: `ga.condition` + `ga.step`
                       device seconds against the `timings` stage-1 +
                       stage-2 seconds; 8 views' projection, binning,
                       graph replays and K1 against the turntable's
                       `timings`
  clock                the profiled runs: the share of device-busy time
                       inside `ga.request`, the largest gap between a
                       span's host start and its profiler range, the
                       `ga.*` names among the device ops (none expected)
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_ns(ops, lo, hi) -> int:
    total, end = 0, None
    for a, b, _ in ops:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def _inside(ops, lo, hi):
    return [o for o in ops if o[0] >= lo and o[1] <= hi]


class _NormCounts:
    """The row-norm kernel's norms (`rownorm.norms`) and the CUDA norms
    kept plain (`rownorm.plain`), split by whether a DiT forward was
    running: forward pre- and post-hooks on the DiTs move the counts made
    inside to `dit`. A CUDA-graph replay runs no Python and adds none."""

    def __init__(self, dits):
        from gaussiananything_tpu_torch.ops import rownorm
        self.rn = rownorm
        self.parts = {"dit": self._zero(), "other": self._zero()}
        self.mark = self._now()
        for m in dits:
            m.register_forward_pre_hook(lambda *a: self._move("other"))
            m.register_forward_hook(lambda *a: self._move("dit"))

    @staticmethod
    def _zero():
        return {"kernel": 0, "plain": collections.Counter()}

    def _now(self):
        return self.rn.rownorm.norms, collections.Counter(self.rn.plain)

    def _move(self, part):
        norms, plain = self._now()
        self.parts[part]["kernel"] += norms - self.mark[0]
        self.parts[part]["plain"].update(plain - self.mark[1])
        self.mark = norms, plain

    def read(self):
        self._move("other")
        out = {}
        for part, c in self.parts.items():
            n_plain = sum(c["plain"].values())
            total = c["kernel"] + n_plain
            out[part] = {"kernel": c["kernel"], "plain": dict(c["plain"]),
                         "plain_share": n_plain / total if total else None}
        return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--out", default="request_spans.json")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import run as bench_run
    bench_run.cache_dirs(ROOT)
    import torch
    from benchmark import core, inputs
    from benchmark.drivers import i23d_requests as drv
    from gaussiananything_tpu_torch.cli import sample
    from gaussiananything_tpu_torch.config import RenderConfig
    from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
    from gaussiananything_tpu_torch.utils import profiling
    from gaussiananything_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    bench = os.path.join(ROOT, "benchmark")
    cfg = core.read_json(bench, "configs", "i23d-release")
    s, r = cfg["sampler"], cfg["render"]
    fm1 = FMConfig(stage=1, cfg_scale=s["cfg_scale"],
                   num_steps=s["num_steps"], sampler=s["method"])
    fm2 = dataclasses.replace(fm1, stage=2)
    rcfg = RenderConfig(output_size=r["output_size"], tile=r["tile"],
                        max_per_tile=r["max_per_tile"], chunk=r["chunk"])
    K = cfg["vae"]["latent_num"]
    images = inputs.object_images(16, cfg["conditioner"]["img_size"],
                                  inputs.generator(args.seed, 1, dev), dev)
    models = drv.build(cfg, args.seed, dev)
    norm_counts = _NormCounts([models.dit1, models.dit2])

    def one(i):
        g = inputs.generator(args.seed, 100 + i, dev)
        x0 = (torch.randn((1, K, 3), generator=g, device=dev),
              torch.randn((1, K, cfg["dit2"]["in_channels"]), generator=g,
                          device=dev))
        t0 = time.perf_counter()
        out = sample.sample_request(models, images[i % 16][None], fm1, fm2,
                                    rcfg, None, x0_stage1=x0[0],
                                    x0_stage2=x0[1], log=lambda _: None)
        out["lods"][-1].to("cpu")
        for v in out["render"].values():
            v.to("cpu")
        return time.perf_counter() - t0, out["timings"]

    def recorded(i, prof_fn=None):
        with profiling.recording(dev) as rec:
            prof = prof_fn() if prof_fn else None
            dt, timings = one(i)
            if prof is not None:
                torch.cuda.synchronize(dev)
                prof.stop()
        return dt, timings, rec.spans(), prof

    for i in range(2):
        one(-1 - i)
    recorded(-3)
    torch.cuda.synchronize(dev)

    lat = {"off": [], "on": []}
    runs = []                       # (timings, spans) of recorded requests
    for i in range(2 * args.requests):
        mode = ("off", "on", "on", "off")[i % 4]
        if mode == "off":
            lat["off"].append(one(i // 2)[0])
        else:
            dt, timings, spans, _ = recorded(i // 2)
            lat["on"].append(dt)
            runs.append((timings, spans))

    by_req = []
    for timings, spans in runs:
        d = collections.defaultdict(list)
        for sp in spans:
            d[sp.name].append(sp)
        by_req.append((timings, d))

    def med(name, f=lambda sp: sp.device_s * 1e3,
            spans=lambda d, name: d[name]):
        v = [f(sp) for _, d in by_req for sp in spans(d, name)]
        return statistics.median(v) if v else None

    def eager(d, name):
        # a view's own projection or binning span (a capture nests them in
        # `ga.render.capture`; span ids are those of one recording)
        views = {sp.id for sp in d["ga.render.view"]}
        return [sp for sp in d[name]
                if sp.parent in views and sp.device_s is not None]

    def dev_s(d, name):
        return sum(sp.device_s for sp in d[name])

    accounts = []
    for timings, d in by_req:
        sampler_s = timings["stage-1 sample"] + timings["stage-2 sample"]
        spans_s = dev_s(d, "ga.condition") + dev_s(d, "ga.step")
        render_s = timings["8-view turntable render"]
        parts_s = sum(sp.device_s for n in ("ga.render.project",
                                            "ga.render.bin")
                      for sp in eager(d, n)) \
            + dev_s(d, "ga.render.replay") + dev_s(d, "ga.kernel.K1")
        accounts.append({"sampler_s": sampler_s,
                         "condition_plus_steps_s": spans_s,
                         "ratio": spans_s / sampler_s,
                         "render_s": render_s,
                         "project_bin_replay_k1_s": parts_s})
    counts = dict(collections.Counter(sp.name for sp in runs[0][1]))
    dit_graphs = [{"replay": len(d["ga.dit.replay"]),
                   "capture": len(d["ga.dit.capture"]),
                   "replay_share": len(d["ga.dit.replay"])
                   / len(d["ga.velocity"])} for _, d in by_req]
    render_graphs = [{"replay": len(d["ga.render.replay"]),
                      "capture": len(d["ga.render.capture"]),
                      "replay_share": len(d["ga.render.replay"])
                      / len(d["ga.render.view"])} for _, d in by_req]
    request_s = statistics.median(dev_s(d, profiling.REQUEST)
                                  for _, d in by_req)

    with profiling.recording(dev) as rec:
        t0 = time.perf_counter()
        for _ in range(2000):
            with profiling.span("ga.cost"):
                pass
        span_cost_us = (time.perf_counter() - t0) / 2000 * 1e6
        rec.spans()

    # the device alone, then the host and the device, each one request
    _, _, spans_d, prof_d = recorded(
        args.requests, lambda: core.device_profile(dev)[0])
    dev_ops, _ = core.device_intervals(prof_d)
    req = next(sp for sp in spans_d if sp.name == profiling.REQUEST)
    velocity = [(sp.device_start_ns, sp.device_end_ns) for sp in spans_d
                if sp.name == "ga.velocity"]

    def n_ops(key, lo_hi):
        return sum(1 for lo, hi in lo_hi for o in _inside(dev_ops, lo, hi)
                   if key in o[2])
    busy_all = _union_ns(dev_ops, 0, 2 ** 63)
    busy_req = _union_ns(dev_ops, req.device_start_ns, req.device_end_ns)
    dit_busy = [_union_ns(dev_ops, sp.device_start_ns, sp.device_end_ns)
                / 1e6 for sp in spans_d if sp.name == "ga.velocity"]
    _, _, spans_h, prof_h = recorded(args.requests + 1,
                                     lambda: core.start_profile(True))
    dev_h, host_h = core.device_intervals(prof_h)
    ranges = collections.defaultdict(list)
    for a, _, name in host_h:
        if name.startswith("ga."):
            ranges[name].append(a)
    starts = collections.defaultdict(list)
    for sp in spans_h:
        starts[sp.name].append(sp.host_start_ns)
    gaps = [abs(a - b) for n in starts
            for a, b in zip(sorted(starts[n]), sorted(ranges[n]))]
    out = {
        "card": core.power_limit(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "seed": args.seed,
        "latency_s": {k: statistics.median(v) for k, v in lat.items()},
        "latencies_s": lat,
        "overhead_pct": (statistics.median(lat["on"])
                         / statistics.median(lat["off"]) - 1) * 100,
        "span_cost_us": span_cost_us,
        "span_counts": counts,
        "cond_s": statistics.median(dev_s(d, "ga.condition")
                                    for _, d in by_req),
        "dit_eval_ms": med("ga.velocity"),
        "dit_eval_host_ms": med("ga.velocity", lambda sp: sp.host_s * 1e3),
        "dit_busy_ms": statistics.median(dit_busy),
        "dit_graphs": dit_graphs,
        "request_device_s": request_s,
        "request_busy_s": busy_req / 1e9,
        "idle_share_plain": (1 - busy_req / 1e9 / request_s) * 100,
        "launches_request": len(_inside(dev_ops, req.device_start_ns,
                                        req.device_end_ns)),
        "project_ms": med("ga.render.project", spans=eager),
        "bin_ms": med("ga.render.bin", spans=eager),
        "replay_ms": med("ga.render.replay"),
        "render_graphs": render_graphs,
        "k1_ms": med("ga.kernel.K1"),
        "view_ms": med("ga.render.view"),
        "step_ms": med("ga.step"),
        "stage_device_s": {n: statistics.median(dev_s(d, n)
                                                for _, d in by_req)
                           for n in ("ga.stage1", "ga.stage2", "ga.decode",
                                     "ga.render")},
        "timings_s": {k: statistics.median(t[k] for t, _ in runs)
                      for k in runs[0][0]},
        "rownorm": {
            "spans_request": statistics.median(
                len(d["ga.kernel.rownorm"]) for _, d in by_req),
            "device_launches_request": n_ops(
                "rownorm", [(req.device_start_ns, req.device_end_ns)]),
            "device_launches_dit": n_ops("rownorm", velocity),
            "mean_reductions_dit": n_ops("MeanOps", velocity),
            "norms": norm_counts.read(),
        },
        "accounts": accounts,
        "clock": {
            "busy_share_inside_request": busy_req / busy_all,
            "max_host_start_gap_us": max(gaps) / 1e3 if gaps else None,
            "ranges_matched": sum(len(v) for v in ranges.values()),
            "ga_names_among_device_ops": sorted(
                {n for *_, n in dev_ops + dev_h if n.startswith("ga.")}),
        },
    }
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
