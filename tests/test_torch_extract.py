"""Latent extraction (`cli/extract_latents.extract_instance`) and its
benchmark cell, on the CPU unless marked `cuda`: the port's encoder
against the benchmark's frozen plain reference
(`benchmark/reference/nets.py`) on one seeded state dict, the anchors
against its farthest-point sampling, `extract_instance` against the loop
body it replaced, its spans, and the cell's driver
(`benchmark/drivers/vae_extract.py`) at a tiny configuration kept here:
a sound run is correct, the control and a planted fault are not. The
`cuda` tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_extract.py

and skip without one. This file imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import extract as ref_extract
from benchmark.reference import nets
from gaussiananything_tpu_torch.cli import extract_latents
from gaussiananything_tpu_torch.models import sd_encoder
from gaussiananything_tpu_torch.ops import fps
from gaussiananything_tpu_torch.utils import precision, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "vae-release-encoder.extract"
SEED = 2 ** 31 + 5151
# the cell's configuration at 2 views of 64², 512 points and K 66: the
# release encoder's widths are fixed (the SD trunk at ch 64, width 256);
# the decoder, built but not run, is cut; K is a multiple of 3, as DiT2's
# three planes ask
TINY_VAE = dict(latent_num=66, decoder_width=64, decoder_depth=2,
                decoder_heads=4, up_factors=[2, 2, 2], up_depths=[1, 1, 1])
TINY_DATA = dict(n_views_in=2, resolution=64, n_points=512, cond_size=32)
TINY_TRAFFIC = dict(instances=2, views=4, points_stored=1024)

torch.set_num_threads(2)


def _config(tiny: bool = True) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs",
                           "vae-release-encoder.json")) as f:
        cfg = json.load(f)
    if tiny:
        cfg["vae"].update(TINY_VAE)
        cfg["data"].update(TINY_DATA)
    return cfg


def _models(cfg, device="cpu"):
    """The port's VAE as the cell builds it and the reference's, from one
    seeded state dict."""
    from benchmark.drivers import vae_extract
    return (vae_extract.build(cfg, SEED, device),
            ref_extract.build(cfg, SEED, device))


def _inputs(cfg, device="cpu", seed=0):
    """A G-buffer draw assembled by the port's data set: (1, V, 15, H, W)
    views, (1, P, 3) points and the supervision view."""
    import tempfile

    from benchmark import inputs
    from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
    d = cfg["data"]
    with tempfile.TemporaryDirectory() as tmp:
        files = inputs.write_gbuffer_set(tmp, seed, 1, d["n_views_in"] + 1,
                                         d["resolution"], 2 * d["n_points"],
                                         device)
        ds = MultiViewDataset(tmp, files=files, n_views_in=d["n_views_in"],
                              n_views_sup=1, n_points=d["n_points"],
                              resolution=d["resolution"], device=device)
        return ds.batch(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = _config()
    prog, ref = _models(cfg)
    return cfg, prog, ref, _inputs(cfg)


def test_encode_matches_reference(tiny):
    """`PointVAE.encode` against the reference's encoder and quant MLP
    under the "ieee" policy. Both compute the same operations in the same
    order in IEEE fp32 on one CPU, and were measured bit-equal; rtol 1e-5
    / atol 1e-6 leaves room for a sum reordered by another thread count
    and nothing more (on the card, TF32 products move the latent by
    ~5e-4 of its mean magnitude; the cell's `latent` limit is 1.3e-3)."""
    cfg, prog, ref, b = tiny
    precision.set_policy("highest")
    noise = torch.randn((1,) + prog.latent_shape,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        dist, anchors = prog.encode(b["images_in"], b["pcd"])
        want = ref_extract.encode(ref, b["images_in"], b["pcd"], noise)
    assert torch.equal(anchors, want["anchors"])
    for name, got in (("mean", dist.mean), ("logvar", dist.logvar),
                      ("z", dist.sample(noise=noise))):
        torch.testing.assert_close(got, want[name], rtol=1e-5, atol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("ties", [False, True])
def test_anchors_equal_reference_fps(ties):
    """The port's farthest-point sampling against `nets.farthest_points`
    bit for bit, points and indices; with every point twice, several
    candidates are equally far and the lowest index must win in both."""
    g = torch.Generator().manual_seed(11)
    pts = torch.randn((2, 512, 3), generator=g)
    if ties:
        pts[:, 256:] = pts[:, :256]
    got, gi = fps.sample_farthest_points(pts, 66)
    want, wi = nets.farthest_points(pts, 66)
    assert torch.equal(gi, wi) and torch.equal(got, want)


def _old_loop_body(model, b, eps, S):
    """The extraction loop's body before `extract_instance` (the witness
    the npz arrays are held to)."""
    from gaussiananything_tpu_torch.utils.image import resize
    with torch.no_grad():
        dist, anchors = model.encode(b["images_in"], b["pcd"])
        z = dist.sample(noise=eps.to(b["images_in"].device, dist.mean.dtype))
        cond = resize(b["images_sup"][0, 0], (S, S), "linear")
    return {"latent_normalized": z[0].cpu().numpy(),
            "query_pcd_xyz": anchors[0].float().cpu().numpy(),
            "cond": cond.cpu().numpy()}


def test_extract_instance_equals_old_loop_body(tiny):
    cfg, prog, _, b = tiny
    eps = torch.randn((1,) + prog.latent_shape,
                      generator=torch.Generator().manual_seed(5))
    S = cfg["data"]["cond_size"]
    arrays, timings = extract_latents.extract_instance(prog, b, eps, S)
    want = _old_loop_body(prog, b, eps, S)
    assert list(arrays) == list(want)
    for k in want:
        assert arrays[k].dtype == want[k].dtype
        np.testing.assert_array_equal(arrays[k], want[k], err_msg=k)
    assert set(timings) == {"encode", "latent and cond"}
    assert all(t >= 0 for t in timings.values())


def test_cli_npz_schema(tmp_path):
    """`main` keeps its arguments and writes the reference's schema: the
    KL sample, the anchors, the conditioning view and the caption."""
    res = extract_latents.main(["--device", "cpu", "--num", "2", "--out",
                                str(tmp_path)])
    assert len(res["files"]) == len(res["seconds"]) == 2
    with np.load(res["files"][1]) as z:
        assert list(z) == ["latent_normalized", "query_pcd_xyz", "cond",
                           "caption"]
        assert z["latent_normalized"].shape == (64, 4)
        assert z["query_pcd_xyz"].shape == (64, 3)
        assert z["cond"].shape == (3, 112, 112)
        assert str(z["caption"])


def test_spans_nest(tiny):
    """One instance under a recorder: `ga.extract` ⊃ `ga.encode` ⊃
    {`ga.encode.trunk`, `ga.encode.fps`, `ga.encode.agg`}, once each, FPS
    with its frame."""
    cfg, prog, _, b = tiny
    eps = torch.zeros((1,) + prog.latent_shape)
    with profiling.recording("cpu") as rec:
        extract_latents.extract_instance(prog, b, eps,
                                         cfg["data"]["cond_size"])
    spans = [s for s in rec.spans() if s.name.startswith("ga.e")]
    by = {s.name: s for s in spans}
    assert sorted(s.name for s in spans) == sorted(
        ["ga.extract", "ga.encode", "ga.encode.trunk", "ga.encode.fps",
         "ga.encode.agg"])
    assert by["ga.extract"].parent is None
    assert by["ga.encode"].parent == by["ga.extract"].id
    for name in ("ga.encode.trunk", "ga.encode.fps", "ga.encode.agg"):
        assert by[name].parent == by["ga.encode"].id, name
    assert by["ga.encode.fps"].attrs == {
        "B": 1, "N": cfg["data"]["n_points"], "K": prog.latent_shape[0]}


# ------------------------------------------------------------ the cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout of the benchmark's data files with the cell at its tiny
    configuration and traffic."""
    from benchmark.tests.tiny import checkout
    r = checkout(str(tmp_path_factory.mktemp("extract")))
    with open(os.path.join(r, "benchmark", "configs",
                           "vae-release-encoder.json"), "w") as f:
        json.dump(_config(), f)
    path = os.path.join(r, "benchmark", "traffic", CELL + ".json")
    with open(path) as f:
        traffic = json.load(f)
    traffic.update(TINY_TRAFFIC)
    with open(path, "w") as f:
        json.dump(traffic, f)
    return r


def _run(root, trace=False, control=False):
    from benchmark import run
    rec, metrics = run.run_cell(root, CELL, SEED, 0.1, trace, device="cpu",
                                control=control)
    return rec, metrics, {n for n, v, lim in rec["checks"] if not v <= lim}


def test_cell_sound_run_is_correct(root):
    """Traced, so the span readers read too (host ms on the CPU); the
    device's idle share and peak are the card's alone."""
    rec, metrics, failed = _run(root, trace=True)
    assert rec["correct"] and not failed, rec["checks"]
    assert rec["attempted"] >= 3
    assert {"encode_ms.extract", "fps_ms.extract", "extract_mfu"} \
        <= set(metrics)
    assert metrics["fps_ms.extract"]["value"] \
        < metrics["encode_ms.extract"]["value"]


def test_cell_control_is_not_correct(root):
    """The reference one step lower (bf16 products, TF32-rounded
    geometry) in the program's place."""
    rec, _, failed = _run(root, control=True)
    assert not rec["correct"] and {"inputs", "latent"} <= failed


def _per_view_attn1(self, x):
    """`MVMidAttention.forward` with attn1 attending within each view
    instead of over all views' tokens."""
    B, V, C, hh, ww = x.shape
    h = self.norm(x.reshape(B * V, C, hh, ww))
    t = self.proj_in(h.permute(0, 2, 3, 1)).reshape(B * V, hh * ww, -1)
    t = t + self.attn1(self.norm1(t))
    t = t + self.attn2(self.norm2(t))
    t = t + self.ff(self.norm3(t))
    t = self.proj_out(t).reshape(B, V, hh, ww, C)
    return x + t.permute(0, 1, 4, 2, 3)


_FIRST_ARGMAX = fps._first_argmax


def _first_argmax_last(x):
    """Ties to the highest index."""
    return x.shape[-1] - 1 - _FIRST_ARGMAX(x.flip(-1))


@pytest.mark.parametrize("fault,number", [
    ((sd_encoder.MVMidAttention, "forward", _per_view_attn1), "latent"),
    ((fps, "_first_argmax", _first_argmax_last), "anchors")],
    ids=["attn1_per_view", "fps_start"])
def test_cell_planted_fault_is_not_correct(root, monkeypatch, fault,
                                           number):
    """A fault planted in the timed path: attn1 per view (part of the
    mathematics left out), or farthest-point sampling that starts at the
    last point and breaks ties to the highest index."""
    monkeypatch.setattr(*fault)
    rec, _, failed = _run(root)
    print(number, rec["read"])
    assert not rec["correct"] and number in failed, rec["checks"]


@pytest.mark.parametrize("device,grad,capturing,engages", [
    ("cuda", False, False, True), ("cuda", True, False, False),
    ("cuda", False, True, False), ("cpu", False, False, False),
    ("cpu", True, False, False)])
def test_fps_graph_route(monkeypatch, device, grad, capturing, engages):
    """The FPS loop replays as a graph only for CUDA points with grad mode
    off and no capture underway: training's calls, and their recomputation
    under activation checkpointing, keep the eager loop."""
    import types
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    # the rule reads only the points' device, so a stand-in does for CUDA
    pts = types.SimpleNamespace(device=torch.device(device))
    with torch.set_grad_enabled(grad):
        assert fps.fps_graph_engages(pts) is engages


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_release_encode_on_the_card():
    """One release-width encode (4 views of 512², 4,096 points) on the
    card under the program's policy (TF32 network products) against the
    reference in IEEE fp32: within the cell's `latent` limit, the anchors
    equal. Every attention of the joint, per-view and cross frames takes
    the fused kernel (`ga.kernel.attn`); the calls left plain are printed
    with their reasons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the release widths run on the card")
    from benchmark.reference.precision import ieee
    from gaussiananything_tpu_torch.models import layers
    from gaussiananything_tpu_torch.ops import attention as attn
    from gaussiananything_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
    cfg = _config(tiny=False)
    prog, ref = _models(cfg, dev)
    b = _inputs(cfg, dev, seed=SEED)
    noise = torch.randn((1,) + prog.latent_shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    plain = []
    route = layers.dot_attention

    def watched(q, k, v, bias=None):
        why = attn.plain_reasons(q, k, v, bias)
        if why:
            plain.append((tuple(q.shape), tuple(k.shape), tuple(why)))
        return route(q, k, v, bias)
    layers.dot_attention = watched
    try:
        with torch.no_grad(), profiling.recording(dev) as rec:
            dist, anchors = prog.encode(b["images_in"], b["pcd"])
            z = dist.sample(noise=noise)
    finally:
        layers.dot_attention = route
    frames = sorted((s.attrs["batch"], s.attrs["queries"], s.attrs["keys"],
                     s.attrs["heads"]) for s in rec.spans()
                    if s.name == "ga.kernel.attn")
    print("ga.kernel.attn frames (B, T, S, H):", frames)
    print("plain attention calls (q, k, reasons):", plain)
    assert frames == sorted([(1, 16384, 16384, 8), (4, 4096, 4096, 8),
                             (1, 768, 16384, 8)])
    rec = {"images": b["images_in"], "pcd": b["pcd"], "noise": noise,
           "mean": dist.mean, "logvar": dist.logvar, "z": z,
           "anchors": anchors}
    with ieee():
        got = ref_extract.compare(ref, rec, rec)
    print("release encode, TF32 against IEEE:", got)
    assert got["anchors"] == 0.0
    assert got["latent"] <= cfg["check"]["limits"]["latent"]


@pytest.mark.cuda
def test_fps_graph_matches_eager():
    """Farthest-point sampling on the card at the release shape (4,096
    points, 768 anchors) with grad mode off, as extraction calls it, four
    clouds in turn, the last with every point
    twice: the first call runs the loop eagerly, the second captures it
    and replays, the others replay. Every index equals the eager loop's
    and the reference's on the same points bit for bit (a graph input
    left stale would not); a masked call takes a key of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is a CUDA graph")
    dev = torch.device("cuda")
    fps.FPS_GRAPHS.entries.clear()
    counts = []
    for seed in range(4):
        pts = torch.randn((1, 4096, 3), device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        if seed == 3:
            pts[:, 2048:] = pts[:, :2048]
        with profiling.recording(dev) as rec, torch.no_grad():
            sel, idx = fps.sample_farthest_points(pts, 768)
        names = [s.name for s in rec.spans()]
        counts.append((names.count("ga.encode.fps.capture"),
                       names.count("ga.encode.fps.replay")))
        assert torch.equal(idx, fps._fps_indices(pts, 768, None)), seed
        want, want_idx = nets.farthest_points(pts, 768)
        assert torch.equal(idx, want_idx) and torch.equal(sel, want), seed
    assert counts == [(0, 0), (1, 1), (0, 1), (0, 1)]
    mask = torch.ones((1, 4096), dtype=torch.bool, device=dev)
    mask[:, :100] = False
    for _ in range(3):
        with torch.no_grad():
            _, idx = fps.sample_farthest_points(pts, 768, mask)
        assert torch.equal(idx, fps._fps_indices(pts, 768, mask))
    assert len(fps.FPS_GRAPHS.entries) == 2


@pytest.mark.cuda
def test_fps_keeps_the_eager_loop_under_grad():
    """The encoder's forward and backward with grad mode on, as training
    runs it, on the card and under activation checkpointing (the whole
    encode recomputed in the backward): FPS captures and replays nothing,
    and its anchors equal the reference's bit for bit in every forward and
    recomputation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is a CUDA graph")
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop
    dev = torch.device("cuda")
    fps.FPS_GRAPHS.entries.clear()
    cfg = _config()
    prog, _ = _models(cfg, dev)
    prog.train()
    b = _inputs(cfg, dev, seed=SEED)
    images = b["images_in"].requires_grad_(True)
    got = []

    def encode(x):
        dist, anchors = prog.encode(x, b["pcd"])
        got.append(anchors.detach().clone())
        return dist.mean.sum() + dist.logvar.sum()
    with profiling.recording(dev) as rec, set_checkpoint_early_stop(False):
        for _ in range(3):
            checkpoint(encode, images, use_reentrant=False).backward()
    names = {s.name for s in rec.spans()}
    assert "ga.encode.fps" in names
    assert not names & {"ga.encode.fps.capture", "ga.encode.fps.replay"}
    assert not fps.FPS_GRAPHS.entries
    assert images.grad is not None and torch.isfinite(images.grad).all()
    want, _ = nets.farthest_points(b["pcd"], cfg["vae"]["latent_num"])
    assert len(got) == 6            # three forwards, three recomputations
    for a in got:
        assert torch.equal(a, want)


@pytest.mark.cuda
def test_gbuffer_batch_on_the_card_equals_the_cpu(tmp_path):
    """The data set converts the drawn views on its device: the card's
    maps equal the CPU's bit for bit (rgb and alpha over 255 by a true
    division, as numpy's `load_instance`), and so do the points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import inputs
    from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
    files = inputs.write_gbuffer_set(str(tmp_path), 3, 2, 8, 128, 1024,
                                     "cpu")
    got = [MultiViewDataset(str(tmp_path), files=files, n_views_in=4,
                            n_views_sup=1, n_points=512, seed=9,
                            device=dev).batch(1) for dev in ("cuda", "cpu")]
    for k in ("images_sup", "alpha_sup", "depth_sup", "pcd"):
        assert torch.equal(got[0][k].cpu(), got[1][k]), k
    # rgb, normal (exact) and the camera-derived channels (other sums)
    a, b = got[0]["images_in"].cpu(), got[1]["images_in"]
    assert torch.equal(a[:, :, :6], b[:, :, :6])
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
