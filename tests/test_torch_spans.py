"""The port's span recorder (`utils/profiling.py`) on the request path:
the no-op span while no recorder is on, the tree of one request of the
tiny-width cascade (the widths of `tests/test_torch_cascade.py`), the
shared clock with `torch.profiler`, `StageTimer`'s laps as spans, and on a
card the kernel spans and the device clock against a device profile. This
file imports neither JAX nor the JAX package; on a card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""
from __future__ import annotations

import collections

import pytest
import torch

from gaussiananything_tpu_torch.cli.sample import (ReleaseModels,
                                                   sample_request)
from gaussiananything_tpu_torch.config import RenderConfig
from gaussiananything_tpu_torch.models.conditioner import ImageConditioner
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
from gaussiananything_tpu_torch.train.vae_trainer import StageTimer
from gaussiananything_tpu_torch.utils import profiling

torch.set_num_threads(2)

W, DEPTH, HEADS, K, ZC, IMG = 128, 2, 2, 12, 10, 56
RES, MPT, CHUNK = 32, 256, 64
STEPS, CFG = 2, 4.5


def _models(device="cpu") -> ReleaseModels:
    torch.manual_seed(0)
    with torch.device(device):
        return ReleaseModels(
            cond=ImageConditioner(width=W, depth=DEPTH, heads=HEADS,
                                  img_size=IMG).eval(),
            dit1=PointDiT(in_channels=3, width=W, depth=DEPTH, heads=HEADS,
                          cond_dim=W, vector_dim=W).eval(),
            dit2=PointDiT(in_channels=ZC, width=W, depth=DEPTH, heads=HEADS,
                          cond_dim=W, vector_dim=W, use_xyz_pe=True).eval(),
            vae=PointVAE(latent_num=K, z_channels=ZC, decoder_width=W,
                         decoder_depth=DEPTH, decoder_heads=HEADS).eval())


def _request(models, device="cpu"):
    g = torch.Generator().manual_seed(1)
    img = torch.rand((1, 3, 64, 64), generator=g).to(device)
    x0 = (torch.randn((1, K, 3), generator=g).to(device),
          torch.randn((1, K, ZC), generator=g).to(device))
    fm1 = FMConfig(stage=1, cfg_scale=CFG, num_steps=STEPS, sampler="heun")
    return sample_request(
        models, img, fm1, FMConfig(stage=2, cfg_scale=CFG, num_steps=STEPS,
                                   sampler="heun"),
        RenderConfig(output_size=RES, max_per_tile=MPT, chunk=CHUNK),
        x0_stage1=x0[0], x0_stage2=x0[1], log=lambda s: None)


@pytest.fixture(scope="module")
def recorded():
    """The same request with the recorder off, then on."""
    models = _models()
    off = _request(models)
    with profiling.recording() as rec:
        on = _request(models)
    return off, on, rec.spans()


def _tensors(out):
    yield from (out["xyz_n"], out["xyz"], out["kl"], *out["lods"])
    yield from (out["render"][k] for k in sorted(out["render"]))


def test_span_is_a_shared_no_op_while_off():
    assert profiling.active() is None
    a, b = profiling.span("ga.x"), profiling.span("ga.y", view=3)
    assert a is b is profiling.NO_SPAN
    with a as entered:
        assert entered is a
    with profiling.recording() as rec:
        assert profiling.active() is rec
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert profiling.active() is None
    with profiling.span("ga.after"):
        pass
    assert [s.name for s in rec.spans()] == []


def test_recording_leaves_the_request_bitwise_unchanged(recorded):
    off, on, spans = recorded
    assert spans
    for a, b in zip(_tensors(off), _tensors(on), strict=True):
        assert torch.equal(a, b)


def test_request_tree(recorded):
    _, _, spans = recorded
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [profiling.REQUEST]
    req = roots[0]
    assert all(s.request == req.id for s in spans)
    n = collections.Counter(s.name for s in spans)
    assert n["ga.condition"] == 2
    assert n["ga.step"] == 2 * STEPS
    assert n["ga.velocity"] == 4 * STEPS          # Heun: two a step
    assert n["ga.render.view"] == 8
    for stage in ("ga.stage1", "ga.stage2", "ga.decode", "ga.render"):
        assert n[stage] == 1 and by_id[next(
            s.parent for s in spans if s.name == stage)] is req
    for s in spans:
        if s.name == "ga.step":
            assert by_id[s.parent].name in ("ga.stage1", "ga.stage2")
        if s.name == "ga.velocity":
            assert by_id[s.parent].name == "ga.step"
        if s.name == "ga.condition":
            assert by_id[s.parent].name in ("ga.stage1", "ga.stage2")
        if s.name == "ga.render.view":
            assert by_id[s.parent].name == "ga.render"
            kids = collections.Counter(c.name for c in spans
                                       if c.parent == s.id)
            assert kids == {"ga.render.project": 1, "ga.render.bin": 1}
    for s in spans:
        assert s.host_start_ns <= s.host_end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.host_start_ns <= s.host_start_ns
            assert s.host_end_ns <= p.host_end_ns
        assert s.device_s is None           # the CPU has no device clock


def test_request_spans_are_the_stage_timings(recorded):
    """Each stage span ends where its `timings` label does, after the
    same synchronise, and starts just after the label's clock starts."""
    _, on, spans = recorded
    labels = {"ga.stage1": "stage-1 sample", "ga.stage2": "stage-2 sample",
              "ga.decode": "VAE cascade decode",
              "ga.render": "8-view turntable render"}
    for s in spans:
        if s.name in labels:
            label = on["timings"][labels[s.name]]
            assert label - 0.05 <= s.host_s <= label


def test_spans_on_the_profilers_clock():
    """Each span's host start lies within 1 ms of the start of the
    profiler's range of the same name (`_KinetoEvent.start_ns`)."""
    models = _models()
    _request(models)                        # warm
    with profiling.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _request(models)
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ga."):
            ranges[e.name()].append(e.start_ns())
    spans = collections.defaultdict(list)
    for s in rec.spans():
        spans[s.name].append(s.host_start_ns)
    assert set(spans) == set(ranges)
    for name, starts in spans.items():
        got = sorted(ranges[name])
        assert len(got) == len(starts), name
        for a, b in zip(sorted(starts), got):
            assert abs(a - b) < 1_000_000, (name, a - b)


@pytest.mark.parametrize("method", ["euler", "heun", "dopri5"])
def test_sampler_steps_and_evaluations(method):
    """One `ga.step` a step (an attempted step of the adaptive solver),
    one `ga.velocity` a guided evaluation, each inside a step except the
    adaptive solver's first evaluation and initial step."""
    from gaussiananything_tpu_torch.diffusion import sampling
    Cond = collections.namedtuple("Cond", "c")
    calls = []

    def velocity(x, t, c):
        calls.append(1)
        return -x * c.c[:, :1, None]

    guided = sampling.cfg_velocity_fn(velocity, Cond(torch.ones(1, 2)),
                                      Cond(torch.zeros(1, 2)), 4.5)
    x0 = torch.randn((1, 5, 3), generator=torch.Generator().manual_seed(0))
    with profiling.recording() as rec:
        if method == "dopri5":
            sampling.sample_ode_adaptive(guided, x0)
        else:
            sampling.sample_ode(guided, x0, num_steps=3, method=method)
    spans = rec.spans()
    n = collections.Counter(s.name for s in spans)
    assert n["ga.velocity"] == len(calls)
    if method != "dopri5":
        assert n["ga.step"] == 3
        assert len(calls) == 3 * (2 if method == "heun" else 1)
    by_id = {s.id: s for s in spans}
    outside = [s for s in spans if s.name == "ga.velocity"
               and (s.parent is None or by_id[s.parent].name != "ga.step")]
    assert len(outside) == (2 if method == "dopri5" else 0)
    if method == "dopri5":
        assert n["ga.step"] >= 1 and len(calls) == 2 + 6 * n["ga.step"]


def test_stage_timer_laps_are_spans():
    """`StageTimer` keeps its keys and sums repeated stages; inside a
    recording each lap is a `ga.train.<stage>` span nested where the step
    runs."""
    timer = StageTimer("cpu")
    with profiling.recording() as rec, profiling.span("ga.step") as outer:
        timer.start()
        torch.ones(64, 64) @ torch.ones(64, 64)
        timer.lap("forward")
        timer.lap("loss")
        timer.start()
        timer.lap("loss")
    assert set(timer.seconds) == {"forward", "loss"}
    assert all(v >= 0 for v in timer.seconds.values())
    spans = rec.spans()
    laps = [s for s in spans if s.name.startswith("ga.train.")]
    assert [s.name for s in laps] == ["ga.train.forward", "ga.train.loss",
                                      "ga.train.loss"]
    assert all(s.parent == outer.id for s in laps)
    assert sum(s.host_s for s in laps if s.name == "ga.train.loss") \
        == pytest.approx(timer.seconds["loss"], abs=1e-6)
    # without a recording the timer still times
    timer = StageTimer("cpu")
    timer.start()
    timer.lap("data")
    assert list(timer.seconds) == ["data"]


# -------------------------------------------------------------- the card


def _device_ops(prof):
    """(start_ns, end_ns) of each device op of a profile, annotations
    left out."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.duration_ns() <= 0 or e.is_user_annotation() \
                or e.name().startswith("ga."):
            continue
        ops.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(ops)


def _union_ns(ops, lo=None, hi=None):
    total, end = 0, None
    for a, b in ops:
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel spans time K1 launches "
                    "and the device clock")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_kernel_spans_and_device_clock(card):
    """On the card: one `ga.kernel.K1` span a K1 launch; every span's
    device interval inside its parent's; in a device-only profile of one
    request, at least 99% of the device-busy time inside the
    `ga.request` span's device interval."""
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    dev = card
    models = _models(dev)
    _request(models, dev)                   # warm: kernels, allocator
    torch.cuda.synchronize()
    before = rasterize_cuda.composite.launches
    with profiling.recording(dev) as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _request(models, dev)
            torch.cuda.synchronize()
    spans = rec.spans()
    k1 = [s for s in spans if s.name == "ga.kernel.K1"]
    assert len(k1) == rasterize_cuda.composite.launches - before == 8
    assert all(s.attrs == {"img_h": RES, "img_w": RES, "row0": 0}
               for s in k1)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.device_start_ns <= s.device_end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.device_start_ns <= s.device_start_ns
            assert s.device_end_ns <= p.device_end_ns
    req = by_id[spans[0].request]
    ops = _device_ops(prof)
    busy = _union_ns(ops)
    inside = _union_ns(ops, req.device_start_ns, req.device_end_ns)
    assert busy > 0 and inside >= 0.99 * busy, (inside, busy)


@pytest.mark.cuda
def test_card_stage_timer_on_events(card):
    """On the card `StageTimer` laps are CUDA events: each stage's seconds
    are its laps' device time, and inside a recording each lap's span has
    that device time."""
    a = torch.randn((2048, 2048), device=card)
    a @ a
    torch.cuda.synchronize()
    timer = StageTimer(card)
    with profiling.recording(card) as rec:
        timer.start()
        for _ in range(20):
            a @ a
        timer.lap("forward")
        timer.lap("loss")
    spans = {s.name: s for s in rec.spans()}
    seconds = timer.seconds
    assert set(seconds) == {"forward", "loss"}
    assert seconds["forward"] > 0 and seconds["forward"] > seconds["loss"]
    assert spans["ga.train.forward"].device_s == pytest.approx(
        seconds["forward"], rel=1e-3, abs=2e-6)
