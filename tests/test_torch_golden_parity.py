"""The port's release-shape golden parity and release-batch tools on the
CPU.

  * The committed artifact `tests/goldens/parity_512_cuda.json`, which
    `python -m gaussiananything_tpu_torch.tools.golden_parity_512` wrote on
    the card, read as tests/test_golden_parity.py reads the JAX ones: the
    release shape (512², 73,728 splats, three views), "pass", every
    path's channels inside the criterion, K2a against the plain path, the
    gradients' bounds (and each gaussian channel's gradient within
    `GRAD_CHANNEL_REL` of that channel's own max), the hashes, and an
    NVIDIA card with its power limit.
  * The tool's own function on the CPU at a small scene (64², 2,048
    splats, `max_per_tile` above the densest tile), inside the same
    criteria, with the plain pair and with the kernels' wrappers (which
    take their plain versions for CPU tensors).
  * The oracle (`rasterize_naive`) and its per-block autograd gradient
    (`oracle_gradient`) against JAX's `rasterize_naive` and `jax.grad` of
    the same loss: atol 2e-5 / rtol 1e-4 on the maps, 2e-3·max|g| on the
    gradient.
  * `fm_feasibility`'s step at tiny widths with two micro-batches.
"""
from __future__ import annotations

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.ops import rasterize as jrz
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.tools import fm_feasibility
from gaussiananything_tpu_torch.tools import golden_parity_512 as gp
from test_torch_rasterize import scene, t

torch.set_num_threads(2)

ART = os.path.join(os.path.dirname(__file__), "goldens",
                   "parity_512_cuda.json")
PATHS = ("channels", "forward", "plain")


@pytest.fixture(scope="module")
def artifact():
    if not os.path.exists(ART):
        pytest.fail("tests/goldens/parity_512_cuda.json missing: run `python "
                    "-m gaussiananything_tpu_torch.tools.golden_parity_512` "
                    "on the card")
    with open(ART) as f:
        return json.load(f)


def _assert_channels(rec):
    for ch, r in rec.items():
        if ch == "depth_median":
            assert r["p999"] <= r["tol"], (ch, r)
            assert r["frac_beyond_tol"] <= 1e-4, (ch, r)
            assert r["max_abs_diff"] <= 0.2, (ch, r)
        else:
            assert r["max_abs_diff"] <= r["tol"], (ch, r)


def _assert_record(rec):
    assert rec["pass"] is True
    assert rec["densest_tile"] < rec["max_per_tile"]
    for path in PATHS:
        assert set(rec[path]) == set(gp.CHANNELS), path
        for ch, r in rec[path].items():
            assert r["tol"] == gp.TOL[ch]
        _assert_channels(rec[path])
    for ch, r in rec["vs_plain"].items():
        assert r["max_abs_diff"] <= (0.2 if ch == "depth_median"
                                     else r["tol"]), (ch, r)
    for key, scale in (("grad", "max_abs_oracle_grad"),
                       ("grad_vs_plain", "max_abs_plain_grad")):
        g = rec[key]
        assert g[scale] > 0, key
        assert g["tol"] == pytest.approx(2e-3 * max(1.0, g[scale])), key
        assert g["max_abs_diff"] <= g["tol"], (key, g)
        assert tuple(g["channels"]) == gp.GAUSSIAN_CHANNELS, key
        for ch, r in g["channels"].items():
            assert r["max_abs_ref"] > 0, (key, ch)
            assert r["max_abs_diff"] <= gp.GRAD_CHANNEL_REL \
                * r["max_abs_ref"], (key, ch, r)


def test_release_shape(artifact):
    assert artifact["res"] == 512
    assert artifact["n_splats"] == 73728
    assert len(artifact["views"]) >= 3
    assert artifact["max_per_tile"] == 8192


def test_errors_within_tolerance(artifact):
    _assert_record(artifact)


def test_image_hashes_and_seconds_recorded(artifact):
    n = len(artifact["views"])
    assert len(artifact["tiled_image_sha256"]) == n
    assert all(len(h) == 64 for h in artifact["tiled_image_sha256"])
    assert len(artifact["seconds"]) == n
    for s in artifact["seconds"]:
        assert set(s) == {"train", "forward", "plain", "oracle",
                          "oracle_grad"}
        assert all(v > 0 for v in s.values())


def test_generated_on_the_card(artifact):
    assert artifact["impl"] == "cuda"
    assert "NVIDIA" in artifact["device"], artifact["device"]
    assert artifact["power_limit"].endswith("W"), artifact["power_limit"]


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_tool_passes_at_a_small_scene(impl):
    rec = gp.run_parity(res=64, n_splats=2048, max_per_tile=2048,
                        device="cpu", impl=impl, pixel_block=1024,
                        log=lambda s: None)
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert len(rec["views"]) == len(rec["tiled_image_sha256"]) == 3
    assert 0 < rec["densest_tile"] < 2048
    _assert_record(rec)


def test_oracle_and_its_gradient_match_jax():
    """The port's oracle maps and `oracle_gradient` (autograd, four pixel
    blocks summed) against JAX's `rasterize_naive` and its `jax.grad` on
    the same splats and camera."""
    res, chunk, block = 32, 64, 256
    g, cam = scene(0, 512, "sphere")
    bg = np.ones(3, np.float32)
    cv, cvp, tf = cam["cam_view"][0], cam["cam_view_proj"][0], \
        cam["tanfov"][0]

    def jloss(gj):
        m = jrz.rasterize_naive(gj, cv, cvp, tf, res, res, jnp.asarray(bg),
                                chunk=chunk, pixel_block=block)
        return sum(w * m[k].sum() for k, w in gp.LOSS_WEIGHTS.items())

    jmaps = jrz.rasterize_naive(jnp.asarray(g), cv, cvp, tf, res, res,
                                jnp.asarray(bg), chunk=chunk,
                                pixel_block=block)
    jgrad = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(g)))
    maps = rz.rasterize_naive(t(g), t(cv), t(cvp), t(bg), res, res,
                              chunk=chunk, pixel_block=block)
    for k in gp.CHANNELS:
        np.testing.assert_allclose(
            maps[k].numpy(),
            np.moveaxis(np.asarray(jmaps[k]).reshape(res, res, -1), -1, 0),
            atol=2e-5, rtol=1e-4, err_msg=k)
    grad = gp.oracle_gradient(t(g), t(cv), t(cvp), t(bg), res, res,
                              chunk=chunk, pixel_block=block).numpy()
    scale = float(np.abs(jgrad).max())
    assert scale > 0
    assert float(np.abs(grad - jgrad).max()) <= 2e-3 * scale


def test_fm_feasibility_step_at_tiny_widths():
    """The tool's step (stage 1, frozen conditioner; stage 2, trained
    conditioner) at batch 4 in two micro-batches: finite logs, one update
    a step, no peak on the CPU."""
    kw = dict(batch=4, accum=2, device="cpu", dit_size="S",
              dit_kw=dict(depth=2, width=64, heads=4, cond_dim=32,
                          vector_dim=32),
              cond_kw=dict(width=32, depth=1, heads=4, img_size=28,
                           backbone="scratch", ucg_rate=0.1),
              n_points=24, log=lambda s: None)
    out = fm_feasibility.feasibility(stage=1, steps=2, **kw)
    assert out["micro"] == 2 and out["steps_taken"] == 3
    assert out["peak_bytes"] is None and len(out["step_s"]) == 2
    assert out["samples_per_s"] > 0
    assert all(math.isfinite(v) for v in out["logs"].values())
    out = fm_feasibility.feasibility(stage=2, steps=0, train_cond=True, **kw)
    assert out["steps_taken"] == 1 and "steady_step_s" not in out
    assert all(math.isfinite(v) for v in out["logs"].values())
