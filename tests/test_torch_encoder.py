"""The port's encoder side against the JAX package's on the CPU: farthest
point sampling, the conv trunks, both `HybridPCDEncoder` layouts, the whole
`PointVAE.forward`, the point-cloud loss and the data assembly. Weights
cross through `from_jax_params`; inputs and noise are numpy draws.
Tolerance atol 2e-4 / rtol 1e-3 as tests/test_torch_models.py (measured
differences are ~1e-6)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.data import postprocess as jpost
from gaussiananything_tpu.data.synthetic import make_batch as jmake_batch
from gaussiananything_tpu.models import layers as jlayers
from gaussiananything_tpu.models.encoder import (
    HybridPCDEncoder as JHybridPCDEncoder, MVConvEncoder as JMVConvEncoder)
from gaussiananything_tpu.models.sd_encoder import \
    SDEncoderTrunk as JSDEncoderTrunk
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.ops.fps import sample_farthest_points as jfps
from gaussiananything_tpu.ops.gaussians import \
    activate_gaussians as jactivate
from gaussiananything_tpu.ops.pointcloud import \
    chamfer_distance as jchamfer
from gaussiananything_tpu.render import cameras as jcameras
from gaussiananything_tpu_torch.data import postprocess as post
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.models.encoder import (HybridPCDEncoder,
                                                       MVConvEncoder)
from gaussiananything_tpu_torch.models.sd_encoder import SDEncoderTrunk
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.ops.fps import sample_farthest_points
from gaussiananything_tpu_torch.ops.gaussians import activate_gaussians
from gaussiananything_tpu_torch.ops.pointcloud import chamfer_distance
from gaussiananything_tpu_torch.render import cameras
from test_torch_models import carry, close, japply, randomize, t

torch.set_num_threads(2)


def _views(seed, B=1, V=2, res=32):
    r = np.random.default_rng(seed)
    img = r.normal(size=(B, V, 15, res, res)).astype(np.float32)
    pcd = r.uniform(-0.4, 0.4, (B, 64, 3)).astype(np.float32)
    return img, pcd


@pytest.mark.parametrize("masked", [False, True])
def test_fps_indices_equal_jax(masked):
    """Index-equal, ties included: a cloud with duplicated points makes
    several candidates equally far, and the lowest index must win."""
    r = np.random.default_rng(0)
    pts = r.normal(size=(2, 40, 3)).astype(np.float32)
    pts[:, 20:] = pts[:, :20]                       # every point twice
    mask = None
    if masked:
        mask = np.ones((2, 40), bool)
        mask[0, :3] = False                         # start at index 3
        mask[1, 25:] = False
    ref_sel, ref_idx = jfps(jnp.asarray(pts), 12,
                            None if mask is None else jnp.asarray(mask))
    sel, idx = sample_farthest_points(
        t(pts), 12, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    assert int(idx[0, 0]) == (3 if masked else 0)


def test_fps_selected_points_carry_gradient():
    pts = t(np.random.default_rng(1).normal(size=(1, 30, 3))
            ).requires_grad_(True)
    sel, idx = sample_farthest_points(pts, 5)
    sel.sum().backward()
    expect = torch.zeros(30)
    expect[idx[0]] = 1.0
    torch.testing.assert_close(pts.grad[0, :, 0], expect)


@pytest.mark.parametrize("size", [32, 30])
def test_same_conv_matches_flax_same_padding(size):
    """Stride-2 3x3 "SAME" on an even and on an odd size."""
    import flax.linen as fnn
    x = np.random.default_rng(2).normal(size=(1, size, size, 5)
                                        ).astype(np.float32)
    jm = fnn.Conv(7, (3, 3), strides=(2, 2))
    p = randomize(jm, 3, jnp.asarray(x))
    ref = japply(jm, p, jnp.asarray(x))
    pm = layers.SameConv2d(5, 7, 3, stride=2)
    pm.load_state_dict({
        "weight": t(p["params"]["kernel"].transpose(3, 2, 0, 1)),
        "bias": t(p["params"]["bias"])})
    with torch.no_grad():
        got = pm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (16, 64)])
def test_res_block(c_in, c_out):
    x = np.random.default_rng(4).normal(size=(2, 8, 8, c_in)
                                        ).astype(np.float32)
    jm = jlayers.ResBlock(c_out)
    p = randomize(jm, 5, jnp.asarray(x))
    ref = japply(jm, p, jnp.asarray(x))
    pm = layers.ResBlock(c_in, c_out)
    flat = p["params"]
    sd = {}
    for tn, jn in (("norm1", "GroupNorm32_0"), ("norm2", "GroupNorm32_1")):
        sd[f"{tn}.weight"] = t(flat[jn]["GroupNorm_0"]["scale"])
        sd[f"{tn}.bias"] = t(flat[jn]["GroupNorm_0"]["bias"])
    convs = [("conv1", "Conv_0"), ("conv2", "Conv_1")]
    if c_in != c_out:
        convs.append(("nin_shortcut", "Conv_2"))
    for tn, jn in convs:
        sd[f"{tn}.weight"] = t(flat[jn]["kernel"].transpose(3, 2, 0, 1))
        sd[f"{tn}.bias"] = t(flat[jn]["bias"])
    pm.load_state_dict(sd)
    with torch.no_grad():
        got = pm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref)


def _nhwc(img):
    return jnp.asarray(np.moveaxis(img, 2, -1))


def test_sd_encoder_trunk():
    img, _ = _views(6)
    jm = JSDEncoderTrunk(ch=32)
    p = randomize(jm, 7, _nhwc(img))
    ref = japply(jm, p, _nhwc(img))                 # (B, V, h, w, C)
    pm = carry(p, SDEncoderTrunk(ch=32))
    with torch.no_grad():
        got = pm(t(img))
    assert got.shape == (1, 2, 128, 4, 4)
    close(got.permute(0, 1, 3, 4, 2), ref)


def test_mv_conv_encoder():
    img, _ = _views(8)
    jm = JMVConvEncoder(ch=32, out_ch=48, heads=4)
    p = randomize(jm, 9, _nhwc(img))
    ref = japply(jm, p, _nhwc(img))
    pm = carry(p, MVConvEncoder(ch=32, out_ch=48, heads=4))
    with torch.no_grad():
        got = pm(t(img))
    close(got.permute(0, 1, 3, 4, 2), ref)


@pytest.mark.parametrize("release", [True, False],
                         ids=["release-layout", "vae-small-layout"])
def test_hybrid_pcd_encoder(release):
    img, pcd = _views(10)
    kw = dict(latent_num=12, z_channels=4, conv_ch=32, heads=4, srt_depth=2)
    kw.update(dict(width=128, conv_out=128) if release
              else dict(width=64, conv_out=48))
    jm = JHybridPCDEncoder(release_parity=release, **kw)
    p = randomize(jm, 11, jnp.asarray(img), jnp.asarray(pcd))
    ref_lat, ref_anchors = japply(jm, p, jnp.asarray(img), jnp.asarray(pcd))
    pm = carry(p, HybridPCDEncoder(release_parity=release, **kw))
    with torch.no_grad():
        lat, anchors = pm(t(img), t(pcd))
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(ref_anchors))
    assert lat.shape == (1, 12, 8)
    close(lat, ref_lat)


@pytest.mark.parametrize("release", [True, False],
                         ids=["release-layout", "vae-small-layout"])
def test_point_vae_forward_with_jax_noise(release):
    """Encode → sample with JAX's own noise → decode; both layouts
    (`anchor_pe`, `activate_gaussians` with `skip_weight`, the upsamplers'
    xyz embedding in the other one)."""
    img, pcd = _views(12)
    K, ZC = 12, 4
    kw = dict(latent_num=K, z_channels=ZC, encoder_width=256 if release
              else 64, decoder_width=64, decoder_depth=2, decoder_heads=2,
              up_factors=(4, 2), up_depths=(1, 1))
    jm = JPointVAE(release_parity=release, **kw)
    key = jax.random.PRNGKey(3)
    p = randomize(jm, 13, jnp.asarray(img), jnp.asarray(pcd), key)
    ref = japply(jm, p, jnp.asarray(img), jnp.asarray(pcd), key)
    noise = jax.random.normal(key, (1, K, ZC), jnp.float32)
    pm = carry(p, PointVAE(release_parity=release, with_encoder=True, **kw))
    with torch.no_grad():
        got = pm(t(img), t(pcd), noise=t(noise))
        lat = pm.latent_for_diffusion(t(img), t(pcd), noise=t(noise))
    for k in ("kl", "mean", "logvar", "anchors", "z"):
        close(got[k], ref[k])
    assert [g.shape[1] for g in got["lods"]] == [12, 48, 96]
    for g, r in zip(got["lods"], ref["lods"]):
        close(g, r)
    ref_lat = japply(jm, p, jnp.asarray(img), jnp.asarray(pcd), key,
                     method=JPointVAE.latent_for_diffusion)
    close(lat, ref_lat)


def test_decoder_only_vae_refuses_to_encode():
    pm = PointVAE(latent_num=12, decoder_width=64, decoder_depth=1,
                  decoder_heads=2, up_factors=(2,), up_depths=(1,))
    assert pm.encoder is None
    with pytest.raises(RuntimeError, match="without its encoder"):
        pm.encode(torch.zeros(1, 1, 15, 16, 16), torch.zeros(1, 8, 3))


def test_diagonal_gaussian_draws_from_a_generator():
    from gaussiananything_tpu_torch.models.vae import DiagonalGaussian
    d = DiagonalGaussian(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    a = d.sample(generator=torch.Generator().manual_seed(5))
    b = d.sample(generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and float(a.std()) > 0.3
    assert torch.equal(d.kl(), torch.zeros(2))


def test_activate_gaussians_matches_jax():
    r = np.random.default_rng(14)
    raw = (3 * r.normal(size=(2, 9, 13))).astype(np.float32)
    anchors = r.uniform(-0.5, 0.5, (2, 9, 3)).astype(np.float32)
    close(activate_gaussians(t(raw), t(anchors), 0.3),
          jactivate(jnp.asarray(raw), jnp.asarray(anchors), 0.3), atol=1e-6)


@pytest.mark.parametrize("masks", [False, True])
def test_chamfer_distance_matches_jax(masks):
    r = np.random.default_rng(15)
    a = r.normal(size=(2, 30, 3)).astype(np.float32)
    b = r.normal(size=(2, 20, 3)).astype(np.float32)
    am = bm = None
    if masks:
        am, bm = r.uniform(size=(2, 30)) > 0.3, r.uniform(size=(2, 20)) > 0.3
    ref = jchamfer(jnp.asarray(a), jnp.asarray(b),
                   None if am is None else jnp.asarray(am),
                   None if bm is None else jnp.asarray(bm))
    got = chamfer_distance(t(a), t(b),
                           None if am is None else torch.from_numpy(am),
                           None if bm is None else torch.from_numpy(bm))
    close(got, ref, atol=1e-5, rtol=1e-5)


def test_encoder_input_assembly_matches_jax():
    r = np.random.default_rng(16)
    B, V, res = 1, 3, 16
    rgb = r.uniform(size=(B, V, 3, res, res)).astype(np.float32)
    nrm = r.normal(size=(B, V, 3, res, res)).astype(np.float32)
    depth = r.uniform(1, 2, (B, V, 1, res, res)).astype(np.float32)
    alpha = r.uniform(size=(B, V, 1, res, res)).astype(np.float32)
    poses = cameras.generate_input_camera(
        1.8, [(10, 20), (40, 130), (-20, 250)])[None]
    ref = jpost.assemble_encoder_input(*(jnp.asarray(x) for x in
                                         (rgb, nrm, depth, alpha, poses)))
    got = post.assemble_encoder_input(*(t(x) for x in
                                        (rgb, nrm, depth, alpha, poses)))
    assert got.shape == (B, V, 15, res, res)
    close(got, ref, atol=1e-5, rtol=1e-5)
    K = poses[..., 16:].reshape(B, V, 3, 3)
    c2w = poses[..., :16].reshape(B, V, 4, 4)
    close(cameras.plucker_rays(t(c2w), t(K), 8, 12),
          jcameras.plucker_rays(jnp.asarray(c2w), jnp.asarray(K), 8, 12),
          atol=1e-6, rtol=1e-6)


def test_make_batch_matches_jax():
    """The same seed gives both packages the same batch (numpy draws; the
    ground-truth views render through each package's own rasterizer)."""
    kw = dict(seed=3, batch=2, n_views_in=1, n_views_sup=2, res=32,
              n_pts=64, n_splats=128)
    ref, got = jmake_batch(**kw), make_batch(**kw)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
