"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name (`benchmark/core.py`); the traffic mix's driver
builds the program from the configuration, makes the weights and inputs
from the seed, warms up, measures for `--seconds`, then checks what the
timed path produced against the plain reference. The last line of
standard output is the result (JSON); the numbers compared, each beside
its limit, are the last lines of standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str):
    """Build caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(base, sub))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: bool = False,
             t_start: float = None):
    """One run; returns the result dict that `main` prints. `device`
    "cpu" and `control` are for the benchmark's tests."""
    from benchmark import core
    spec = core.load_spec(root)
    w = core.cell(spec, workload)
    bench = os.path.join(root, "benchmark")
    cfg = core.read_json(bench, "configs", w["config"])
    traffic = core.read_json(bench, "traffic", w["traffic"])
    drv = core.driver(traffic["kind"])
    rec = drv.run(cfg, traffic, seed=seed, seconds=seconds, trace=trace,
                  device=device, control=control,
                  t_start=T_PROCESS if t_start is None else t_start)
    metrics = core.read_metrics(bench, core.cell_metrics(spec, workload,
                                                         trace), rec)
    return rec, metrics


def main(argv=None):
    args = parse(argv)
    root = os.getcwd()
    cache_dirs(root)
    sys.path.insert(0, root)
    import torch
    from benchmark import core
    spec = core.load_spec(root)
    chips = core.cell(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {core.power_limit()}", file=sys.stderr, flush=True)
    rec, metrics = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace))
    found = core.jax_modules()
    if found:
        print(f"JAX was loaded: {found}", file=sys.stderr, flush=True)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(rec["peak_bytes"])}
    if args.trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    core.emit(core.result(rec, metrics, device, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
