"""The port's span recorder and its `torch.profiler` traces (port of
`gaussiananything_tpu/utils/profiling.py`).

The reference has only ad-hoc profiling (commented torch.profiler blocks,
`logger.profile_kv` timers). Here the request path opens a span at each
layer boundary: `span(name, **attrs)`. While no recorder is on, which is
the default, a span is one shared no-op object: no allocation, no CUDA
call, no profiler range. Inside `recording(device)` each span keeps its
name, its attributes, its id, its parent's id, the id of the enclosing
`ga.request` and its host start and end in ns; on a CUDA device also a
start and an end CUDA event on the current stream, which nothing waits
for until `Recorder.spans()` synchronises once and resolves every span's
device start and end on the host clock. Each span is also a
`torch.profiler.record_function` range, so under `trace` (or any
profile) it lands in the same trace as the kernels.

One clock: host ns are `time.perf_counter_ns()` plus an offset read once
when recording starts, onto the unix-epoch ns that `torch.profiler`'s
events carry (`_KinetoEvent.start_ns()`), so a span's host and device
times compare with the profiler's host and device events directly.

The count of a span name inside one request is that request's counter
(DiT evaluations, Heun steps, views, kernel launches).

The program's spans, where they are opened:

  ga.request               `cli/sample.sample_request`, the whole request
  ga.stage1, ga.stage2,    the same boundaries as `sample_request`'s
  ga.decode, ga.render     `timings` labels
  ga.condition             the conditioner's pass in
                           `train/fm_trainer.make_sampler`
  ga.step                  each step of `diffusion/sampling.sample_ode`,
                           each attempted step of `sample_ode_adaptive`
  ga.velocity              each guided evaluation (`cfg_velocity_fn`: the
                           CFG-batched network call, its concatenations
                           and the combine)
  ga.dit.replay            each replay of a DiT forward's CUDA graph, and
  ga.dit.capture           each capture (`models/dit._ForwardGraphs`; a
                           capturing call replays too; `ga.velocity` less
                           `ga.dit.replay` is the evaluations run eagerly)
  ga.render.view           each view of `render/renderer.render_multiview`
  ga.render.project        projection and splat table in
                           `ops/rasterize._frame` (`rasterize_tiled`)
  ga.render.bin            its binning (`build_tile_pairs`); both open on
                           eager calls and captures, not on replays
  ga.render.replay         each replay of a view's projection and binning
  ga.render.capture        as a CUDA graph, and each capture
                           (`ops/rasterize.FRAME_GRAPHS`; a capturing call
                           replays too), with the view's frame
  ga.kernel.<id>           each launch of a hand-written kernel
                           (`ops/rasterize_cuda`, `ops/attention`: attn),
                           with its frame; a launch captured into a CUDA
                           graph opens its span at the capture only
  ga.train.<stage>         each lap of `train/vae_trainer.StageTimer`
  ga.extract               `cli/extract_latents.extract_instance`, one
                           instance: encode, KL sample, conditioning view
  ga.encode                `models/vae.PointVAE.encode` (the encoder and
                           the quant MLP)
  ga.encode.trunk          the encoder's conv trunk with its multi-view
                           mid attention (`models/encoder`)
  ga.encode.fps            each `ops/fps.sample_farthest_points`, with B,
                           N and K as attributes; `ga.encode.fps.replay`
                           and `.capture` inside where its loop replays or
                           captures as a CUDA graph (`ops/fps.FPS_GRAPHS`)
  ga.encode.agg            the anchors' cross-attention to the tokens, the
                           transformer blocks and the output MLP
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

REQUEST = "ga.request"


@contextlib.contextmanager
def trace(logdir: str):
    """Record CPU and (where there is a card) CUDA activity in scope;
    writes `<logdir>/trace.json` (Chrome trace format) on exit and yields
    the `torch.profiler.profile`, whose `key_averages()` a caller may
    read. Spans show in it only inside a `recording`."""
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


class _NoSpan:
    """What `span` returns while no recorder is on."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
_recorder: Optional["Recorder"] = None


def span(name: str, **attrs):
    """A context manager around one layer of the program: `NO_SPAN` while
    no recorder is on, else a new `Span` of the recorder."""
    rec = _recorder
    if rec is None:
        return NO_SPAN
    return Span(rec, name, attrs)


def active() -> Optional["Recorder"]:
    """The recorder that is on, or None."""
    return _recorder


class Mark:
    """One point in time: host ns on `time.perf_counter_ns`'s clock, and
    on a CUDA device an event recorded on the current stream, unless that
    stream is being captured into a CUDA graph (nothing runs on the device
    then, and an event recorded into a capture has no time)."""
    __slots__ = ("host_ns", "event")

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda" and \
                not torch.cuda.is_current_stream_capturing():
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(device))
        self.host_ns = time.perf_counter_ns()

    def seconds_to(self, other: "Mark") -> float:
        """From this mark to `other`: device seconds between the events
        (after they complete), else host seconds."""
        if self.event is not None:
            return self.event.elapsed_time(other.event) / 1e3
        return (other.host_ns - self.host_ns) / 1e9


class Span:
    """One recorded span. Host times are in ns on the profiler's clock;
    `device_start_ns` and `device_end_ns` are on the same clock once
    `Recorder.spans()` has resolved them (None on the CPU, and for a span
    opened while its stream was being captured into a CUDA graph)."""
    __slots__ = ("name", "attrs", "id", "parent", "request", "host_start_ns",
                 "host_end_ns", "device_start_ns", "device_end_ns", "_rec",
                 "_start", "_end", "_range")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.id = next(rec._ids)
        self.host_start_ns = self.host_end_ns = None
        self.device_start_ns = self.device_end_ns = None
        self._start = self._end = self._range = None

    def _open(self, stack: List["Span"]):
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else None
        self.request = self.id if self.name == REQUEST else (
            outer.request if outer else None)
        self._rec._spans.append(self)

    def __enter__(self):
        stack = self._rec._stack()
        self._open(stack)
        stack.append(self)
        self._range = record_function(self.name)
        self._range.__enter__()
        self._start = Mark(self._rec.device)
        self.host_start_ns = self._start.host_ns + self._rec.offset_ns
        return self

    def __exit__(self, *exc):
        self._end = Mark(self._rec.device)
        self.host_end_ns = self._end.host_ns + self._rec.offset_ns
        self._range.__exit__(*exc)
        self._range = None
        self._rec._stack().pop()
        return False

    @property
    def device_s(self) -> Optional[float]:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e9

    @property
    def host_s(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e9


class Recorder:
    """The spans of one `recording`, in the order they were opened. Each
    thread nests its own spans (the autograd engine's device thread opens
    those of a backward, with no parent)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._spans: List[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()
        self.anchor = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        if self.device.type == "cuda":
            # the idle device reaches the anchor as it is recorded
            self.anchor = Mark(self.device)
        self.anchor_ns = time.perf_counter_ns() + self.offset_ns

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, name: str, start: Mark, end: Mark, **attrs) -> Span:
        """A span between two marks taken already (a lap of a timer),
        nested under this thread's innermost open span; no profiler
        range."""
        s = Span(self, name, attrs)
        s._open(self._stack())
        s._start, s._end = start, end
        s.host_start_ns = start.host_ns + self.offset_ns
        s.host_end_ns = end.host_ns + self.offset_ns
        return s

    def spans(self) -> List[Span]:
        """Every span recorded so far, opened or added, with its device
        times resolved: one synchronise, then each start is the anchor's
        host ns plus the device time from the anchor to the span's start
        event, and each end the start plus the span's device time."""
        if self.anchor is not None:
            torch.cuda.synchronize(self.device)
            for s in self._spans:
                if s.device_start_ns is None and s._end is not None \
                        and s._start.event is not None:
                    s.device_start_ns = self.anchor_ns + round(
                        self.anchor.event.elapsed_time(s._start.event) * 1e6)
                    s.device_end_ns = s.device_start_ns + round(
                        s._start.event.elapsed_time(s._end.event) * 1e6)
        return list(self._spans)


@contextlib.contextmanager
def recording(device="cpu"):
    """Turn the recorder on for the block (one at a time) and yield it;
    its spans stay in memory, readable after the block."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already on")
    rec = Recorder(device)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
