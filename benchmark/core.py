"""What every cell shares: the spec in `BENCHMARK.json`, the files a cell
is made of, the metric readers, the trace reduction, the no-JAX check and
the result line.

A cell names a configuration and a traffic mix. The configuration is
`benchmark/configs/<config>.json`; the traffic mix is
`benchmark/traffic/<traffic>.json`, whose `"kind"` names the driver
`benchmark/drivers/<kind>.py` that runs it; each metric is
`benchmark/metrics/<name>.py`, whose `read(rec)` takes the run's record
and returns a number, or None where the run has nothing to read.
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiananything_tpu")


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def read_json(bench_dir: str, kind: str, name: str) -> dict:
    path = os.path.join(bench_dir, kind, name + ".json")
    if not os.path.isfile(path):
        raise SystemExit(f"missing {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def cell_metrics(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced; a metric without `workloads` belongs to
    every cell."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(bench_dir: str, name: str):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(bench_dir: str, metrics: List[dict], rec: dict) -> dict:
    out = {}
    for m in metrics:
        v = reader(bench_dir, m["name"])(rec)
        if v is None or not math.isfinite(v):
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


# ------------------------------------------------------------- the trace


def device_intervals(prof) -> Tuple[List[Tuple[int, int, str]],
                                    List[Tuple[int, int, str]]]:
    """(device ops, host ops) of a `torch.profiler` run as
    (start_ns, end_ns, name), each sorted by start."""
    import torch
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the benchmark's spans have device copies: not device work
            kind = getattr(e, "activity_type", lambda: "")()
            if not (e.is_user_annotation() or e.name().startswith("bench.")
                    or "annotation" in str(kind)):
                dev.append((s, s + d, e.name()))
        else:
            host.append((s, s + d, e.name()))
    dev.sort()
    host.sort()
    return dev, host


def busy_seconds(dev) -> float:
    """The seconds covered by the union of the device ops."""
    busy, end = 0, None
    for s, e, _ in dev:
        if end is None or s > end:
            busy, end = busy + (e - s), e
        elif e > end:
            busy, end = busy + (e - end), e
    return busy / 1e9


def reduce_trace(dev, host, t0_ns: int, t1_ns: int,
                 top: int = 10) -> dict:
    """Busy seconds in [t0, t1] (the union of device ops), the device ops
    that took most time, and the longest idle gaps grouped by the host op
    that was running as each gap began (the innermost one, with the
    benchmark's span around it)."""
    by_name: Dict[str, int] = {}
    merged: List[List[int]] = []
    for s, e, name in dev:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        by_name[name] = by_name.get(name, 0) + (e - s)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, last = [], t0_ns
    for s, e in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1_ns > last:
        gaps.append((last, t1_ns))
    spans = [h for h in host if h[2].startswith("bench.")]
    ops = [h for h in host if not h[2].startswith("bench.")]
    idle: Dict[str, int] = {}
    for g0, g1 in gaps:
        key = _host_at(spans, g0) + "/" + _host_at(ops, g0)
        idle[key] = idle.get(key, 0) + (g1 - g0)
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "device_ops": [[n, v / 1e9] for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v / 1e9] for n, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def _host_at(events, t: int) -> str:
    """The innermost (latest-starting) of the last 2000 events that
    started by t and cover it; "python" where none does."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    for s, e, name in reversed(events[max(0, i - 2000):i]):
        if e >= t:
            return name
    return "python"


class span:
    """A profiler span named `name` around a block, when `on`."""

    def __init__(self, on: bool, name: str):
        import torch
        self.rf = torch.profiler.record_function(name) if on else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()

    def __exit__(self, *a):
        if self.rf is not None:
            self.rf.__exit__(*a)


def start_profile(cuda: bool, cpu: bool = True):
    """A started `torch.profiler` run over the host (unless not `cpu`)
    and, on a card, the device."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def device_profile(dev):
    """A profile of the device alone, started after a synchronise, and
    the host clock then; on the CPU no profile."""
    import torch
    if dev.type != "cuda":
        return None, time.perf_counter()
    torch.cuda.synchronize(dev)
    return start_profile(True, cpu=False), time.perf_counter()


def busy_window(prof, dev, t0: float) -> dict:
    """The device's busy seconds in `device_profile`'s profile, and the
    host clock's window from its start to a synchronise."""
    import torch
    if prof is None:
        return {"busy_s": 0.0, "window_s": time.perf_counter() - t0}
    torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    prof.stop()
    dev_ev, _ = device_intervals(prof)
    return {"busy_s": busy_seconds(dev_ev), "window_s": window}


# --------------------------------------------------------------- result


def outcome(cfg: dict, worst: Dict[str, float], attempted: int, peak: int,
            window_s: float, trace: dict) -> dict:
    """A run's record: each number the check compared beside its limit
    (the configuration's `check.limits`), `correct` when every number is
    within its limit."""
    limits = cfg["check"]["limits"]
    checks = [(k, worst[k], limits[k]) for k in limits]
    for k in sorted(set(worst) - set(limits)):
        print(f"read, not compared: {k} {worst[k]!r}", file=sys.stderr)
    return {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": attempted, "failed": 0, "checks": checks,
            "read": dict(worst),
            "peak_bytes": peak, "window_s": window_s, "trace": trace}


def result(rec: dict, metrics: dict, device: dict, traced: bool) -> dict:
    """The result line: `correct`, `attempted`, `failed`, `metrics`,
    `device`, with `--trace 1` the `breakdown`, and last the numbers
    compared, each with its limit, under `checks`."""
    out = {"correct": bool(rec["correct"]), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": device}
    if traced:
        out["breakdown"] = {"device_ops": rec["trace"].get("device_ops", []),
                            "idle_gaps": rec["trace"].get("idle_gaps", [])}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rec["checks"]}
    return out


def emit(out: dict):
    """The checks on standard error as its last lines, then the result as
    the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
