"""Profiling helpers: `torch.profiler` traces and wall-time scopes (port
of `gaussiananything_tpu/utils/profiling.py`).

The reference has only ad-hoc profiling (commented torch.profiler blocks,
`logger.profile_kv` timers). `trace(logdir)` records the host and the
card's kernels of everything in scope and writes a trace TensorBoard's
profiler plugin and chrome://tracing read; `annotate` adds named ranges
that show up inside it; `Timer` accumulates wall-time scopes.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Record CPU and (where there is a card) CUDA activity in scope;
    writes `<logdir>/trace.json` (Chrome trace format) on exit and yields
    the `torch.profiler.profile`, whose `key_averages()` a caller may
    read."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named range inside a profiler trace (host and device timeline)."""
    return record_function(name)


class Timer:
    """Accumulating wall-time scopes (`logger.profile_kv` parity)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        """Time the scope; with `block_on` (a tensor), wait for its
        device's queued work before reading the clock."""
        t0 = time.perf_counter()
        yield
        if torch.is_tensor(block_on) and block_on.device.type == "cuda":
            torch.cuda.synchronize(block_on.device)
        self.totals[name] = self.totals.get(name, 0.0) + (
            time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] for k in self.totals}
