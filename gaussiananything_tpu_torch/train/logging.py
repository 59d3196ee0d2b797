"""Metrics logger with CSV and JSONL writers (port of
`gaussiananything_tpu/train/logging.py`; TensorBoard only when
`torch.utils.tensorboard` is importable).

The `logkv` / `logkv_mean` / `dumpkvs` semantics of the OpenAI-baselines
logger the reference uses (its `logger.py:37-249`), and a
`profile` context for wall-time scopes (`:306-318`).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict


class MetricLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._csv_path = os.path.join(logdir, "progress.csv")
        self._jsonl = open(os.path.join(logdir, "progress.jsonl"), "a")
        # on resume, adopt the existing file's header
        self._csv_keys = None
        if os.path.exists(self._csv_path):
            with open(self._csv_path) as f:
                header = f.readline().strip()
            if header:
                self._csv_keys = header.split(",")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(logdir, "tb"))
            except ImportError:
                self._tb = None

    def logkv(self, key: str, value: float):
        self._sums[key] = float(value)
        self._counts[key] = 1

    def logkv_mean(self, key: str, value: float):
        self._sums[key] += float(value)
        self._counts[key] += 1

    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        yield
        self.logkv_mean(f"time/{name}", time.perf_counter() - t0)

    def dumpkvs(self, step: int) -> Dict[str, float]:
        kvs = {k: self._sums[k] / max(self._counts[k], 1)
               for k in sorted(self._sums)}
        self._sums.clear()
        self._counts.clear()
        row = {"step": step, **kvs}
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._csv_keys is None:
            self._csv_keys = list(row)
            with open(self._csv_path, "a") as f:
                f.write(",".join(self._csv_keys) + "\n")
        elif any(k not in self._csv_keys for k in row):
            # new keys: rewrite the file under the extended header, earlier
            # rows padded with blanks (the reference's `logger.py:136-158`)
            self._csv_keys += [k for k in row if k not in self._csv_keys]
            with open(self._csv_path) as f:
                lines = f.readlines()[1:]
            with open(self._csv_path, "w") as f:
                f.write(",".join(self._csv_keys) + "\n")
                for ln in lines:
                    ln = ln.rstrip("\n")
                    n = ln.count(",") + 1
                    f.write(ln + "," * (len(self._csv_keys) - n) + "\n")
        with open(self._csv_path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._csv_keys)
                    + "\n")
        if self._tb is not None:
            for k, v in kvs.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()
        parts = " | ".join(f"{k} {v:.4g}" for k, v in kvs.items()
                           if not k.startswith("time/"))
        print(f"[step {step}] {parts}", flush=True)
        return kvs

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger(MetricLogger):
    """A `MetricLogger` that keeps its sums and writes nothing: the logger
    of every rank but the first in a multi-rank run."""

    def __init__(self):
        self.logdir = None
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def dumpkvs(self, step: int) -> Dict[str, float]:
        kvs = {k: self._sums[k] / max(self._counts[k], 1)
               for k in sorted(self._sums)}
        self._sums.clear()
        self._counts.clear()
        return kvs

    def close(self):
        pass
