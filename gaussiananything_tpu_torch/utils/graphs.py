"""CUDA graphs of a function's no-grad calls, by key: the DiT forwards
(`models/dit._ForwardGraphs`), each view's projection and binning
(`ops/rasterize.rasterize_tiled`) and the farthest-point loop
(`ops/fps.sample_farthest_points`).

A graph holds the addresses of the tensors it was captured on and the
kernels chosen then, so its caller's key is everything that fixes them:
the inputs' shapes and dtypes, the device and current stream, the fp32
matmul policy, inference mode, and whatever else the function reads
besides its tensor arguments.

The first call with a key runs eagerly (it creates cuBLAS handles and
workspaces, and a key that never comes back costs no capture), the second
captures on a side stream and replays, every later one copies its inputs
into the graph's own and replays. At most `LIMIT` keys are kept, the
least recently used evicted. Each graph has its own memory pool: graphs
share nothing, so two streams may replay two of them at once.
"""
from __future__ import annotations

import collections
import threading

import torch

from gaussiananything_tpu_torch.utils import profiling


class GraphCache:
    """The graphs of one function by key, with the spans `<span>.capture`
    (each capture; the capturing call replays too) and `<span>.replay`
    (each replay). A replay returns the graph's own output tensors, which
    the next replay of the key overwrites: callers hold `lock` from `run`
    until they have read them (or cloned them) on the current stream."""
    LIMIT = 4

    def __init__(self, span: str):
        self.span = span
        self.lock = threading.Lock()
        self.entries = collections.OrderedDict()   # key -> None (seen once)
        #                                            or (graph, ins, out)

    def __reduce__(self):
        # copies and pickles start with no graph
        return type(self), (self.span,)

    def run(self, key, body, args, clone: bool = False, **attrs):
        """`body(*args)` under `key` → (out, replayed). `args` are tensors
        or None; with `clone` a replay returns a clone of the graph's
        output (one tensor). `attrs` go to the capture and replay spans."""
        if key not in self.entries:
            out = body(*args)
            self.entries[key] = None
            if len(self.entries) > self.LIMIT:
                self.entries.popitem(last=False)
            return out, False
        self.entries.move_to_end(key)
        entry = self.entries[key]
        if entry is None:
            with profiling.span(self.span + ".capture", **attrs):
                ins = tuple(None if a is None else a.clone() for a in args)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    out = body(*ins)
            self.entries[key] = (graph, ins, out)
        else:
            graph, ins, out = entry
            for dst, src in zip(ins, args):
                if dst is not None:
                    dst.copy_(src)
        with profiling.span(self.span + ".replay", **attrs):
            graph.replay()
            return (out.clone() if clone else out), True
