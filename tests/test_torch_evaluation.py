"""The port's evaluation module against the JAX package's on the CPU:
Sinkhorn EMD, the image and geometry metrics, the novel-view evaluation
of a VAE under a given set of weights, and the turntable strip."""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.ops import pointcloud as jpc
from gaussiananything_tpu.train import evaluation as jev
from gaussiananything_tpu.train import losses as JL
from gaussiananything_tpu_torch.data.synthetic import make_batch, make_object
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.ops import pointcloud as pc
from gaussiananything_tpu_torch.train import evaluation as ev
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.utils.param_io import from_jax_params

torch.set_num_threads(2)

SIZES = dict(latent_num=12, z_channels=4, decoder_width=64, decoder_depth=2,
             decoder_heads=2, up_factors=(4,), up_depths=(1,))
LODS = (16, 32)


@pytest.fixture
def jax_pyramid(monkeypatch):
    """The port's fallback perceptual net carrying the JAX package's
    pyramid weights, as `image_metrics` reads it."""
    _, p = JL._perceptual_params()
    net = L.PerceptualNet()
    net.load_state_dict(from_jax_params(p, net))
    net.requires_grad_(False)
    monkeypatch.setattr(L, "default_perceptual_net", lambda *a, **k: net)


def _cloud(seed, n):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n,m", [(50, 40), (64, 64)])
def test_sinkhorn_emd_matches_jax(n, m):
    """200 log-domain iterations at eps 0.05 in fp32, batched: rtol 1e-4."""
    a = np.stack([_cloud(0, n), _cloud(1, n)])
    b = np.stack([_cloud(2, m), _cloud(3, m) * 0.5])
    ref = np.asarray(jpc.sinkhorn_emd(jnp.asarray(a), jnp.asarray(b)))
    got = pc.sinkhorn_emd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
    same = pc.sinkhorn_emd(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same.max()) < float(got.min())


def test_image_metrics_match_jax(jax_pyramid):
    """PSNR, SSIM and the perceptual distance on the same images: rtol
    1e-4 (the loss tolerance of test_torch_training.py)."""
    r = np.random.default_rng(0)
    gt = r.uniform(0, 1, (2, 3, 3, 32, 32)).astype(np.float32)
    pred = np.clip(gt + r.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    ref = jev.image_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = ev.image_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(got) == set(ref) == {"psnr", "ssim", "perceptual"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_geometry_metrics_match_jax():
    """Chamfer and EMD at rtol 1e-4; precision, recall and F-score are
    shares of 1/N steps, equal unless a distance sits on the threshold."""
    pred, gt = _cloud(4, 300), _cloud(5, 250)
    ref = jev.geometry_metrics(jnp.asarray(pred), jnp.asarray(gt),
                               f_thresh=0.08)
    got = ev.geometry_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                              f_thresh=0.08)
    assert set(got) == set(ref)
    for k in ("chamfer", "emd"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    for k in ("precision", "recall", "fscore"):
        assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert 0 < got["fscore"] < 1


@pytest.fixture(scope="module")
def vae():
    pbatch = {k: v for k, v in make_batch(
        seed=1, batch=1, n_views_in=2, n_views_sup=2, res=32, n_pts=128,
        n_splats=256).items() if k != "gt_gaussians"}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}
    jm = JPointVAE(encoder_width=256, release_parity=True, **SIZES)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(jm.init)(key, jbatch["images_in"], jbatch["pcd"], key)
    pm = PointVAE(encoder_width=256, release_parity=True, with_encoder=True,
                  **SIZES)
    weights = from_jax_params(jax.tree.map(np.asarray, jparams), pm)
    return dict(pbatch=pbatch, jbatch=jbatch, jm=jm, jparams=jparams, pm=pm,
                weights=weights)


def test_eval_novelview_matches_jax(vae, jax_pyramid, tmp_path):
    """The port's model holds other weights; `eval_novelview` evaluates the
    ones it is given (here JAX's) and leaves the model's own as they were.
    The metrics within 2e-3 of JAX's (the rasterizer's tolerance,
    test_torch_training.py), and the same PNG grid: one row per LoD and
    the ground truth, pixels at most one step apart in 1% of them."""
    pm = vae["pm"]
    own = {k: v + 0.01 for k, v in vae["weights"].items()}
    pm.load_state_dict(own)
    params = {k: v for k, v in vae["weights"].items()
              if k in dict(pm.named_parameters())}
    rng = jax.random.PRNGKey(4)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        rng, (1, SIZES["latent_num"], SIZES["z_channels"]))))
    got = ev.eval_novelview(pm, params, vae["pbatch"], LODS,
                            out_dir=str(tmp_path / "port"), step=7,
                            draws={"noise": noise})
    ref = jev.eval_novelview(vae["jm"], vae["jparams"], vae["jbatch"], rng,
                             LODS, out_dir=str(tmp_path / "jax"), step=7)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-3, atol=1e-5,
                                   err_msg=k)
    assert all(torch.equal(v, own[k]) for k, v in pm.state_dict().items())
    a = np.asarray(Image.open(tmp_path / "port" / "eval_0000007.png"))
    b = np.asarray(Image.open(tmp_path / "jax" / "eval_0000007.png"))
    assert a.shape == b.shape == (3 * 32, 2 * 32, 3)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_eval_novelview_draws_from_the_generator(vae):
    """Without draws the noise comes from the generator: two generators of
    one seed give the same metrics."""
    params = dict(vae["pm"].named_parameters())
    m = [ev.eval_novelview(vae["pm"], params, vae["pbatch"], LODS,
                           generator=torch.Generator().manual_seed(3))
         for _ in range(2)]
    assert m[0] == m[1] and np.isfinite(m[0]["eval/psnr"])


def test_export_turntable_matches_jax(tmp_path):
    """The PNG strip of every (n_frames // 8)-th frame, as JAX's fallback
    writes it when no video writer is installed; pixels one step apart at
    most in 1% of them."""
    g = make_object(0, n=256)
    got = ev.export_turntable(str(tmp_path / "p.mp4"), g, n_frames=16,
                              res=32)
    assert got == str(tmp_path / "p.png")
    jev.export_turntable(str(tmp_path / "j.mp4"), jnp.asarray(g.numpy()),
                         n_frames=16, res=32)
    a = np.asarray(Image.open(got))
    b = np.asarray(Image.open(tmp_path / "j.png"))
    assert a.shape == b.shape == (32, 8 * 32, 3)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    assert a.min() < 200       # the object is in the frames
