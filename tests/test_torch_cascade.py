"""The whole slice at small size: the JAX cascade of `cli/sample.py
--release` (make_sampler → stage handoff → make_sampler → PointVAE.decode →
render_multiview(impl="xla")) against the port's `sample_request`, with the
same weights (carried by `from_jax_params`) and the same initial noise (the
JAX draws handed over as numpy). 4 Euler steps at CFG 4.5, as
`tests/test_release_cascade.py`.

Tolerances: the networks agree to ~1e-5 relative (test_torch_models), and
each guided Euler step evaluates 5.5·v_cond − 4.5·v_uncond, which scales
that difference by ~10: over 4 steps of dt 0.25 the sampled latents may
differ by ~1e-4 of their largest |value| (~10 on these random weights), so
they are held to 3e-4 of it, and the LoDs they decode to atol 1e-3. The render composites the decoded splats: a 1e-5
shift of a splat can flip a pixel's `alpha ≥ 1/255` keep test, so each map
is held to 2e-3 at p99.9 and to 1e-4 on the mean. dist peaks at ~6e-7
here, at the fp32 floor of its running sums, so these bounds say nothing of
it: `test_torch_rasterize.py` holds dist to its own size on scenes where it
stands above that floor.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.data.synthetic import \
    render_scene_views as jrender_scene_views
from gaussiananything_tpu.data.synthetic import make_object as jmake_object
from gaussiananything_tpu.models.conditioner import \
    ImageConditioner as JImageConditioner
from gaussiananything_tpu.models.dit import PointDiT as JPointDiT
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.render import cameras as jcameras
from gaussiananything_tpu.render.renderer import \
    render_multiview as jrender_multiview
from gaussiananything_tpu.train.fm_trainer import FMConfig as JFMConfig
from gaussiananything_tpu.train.fm_trainer import XYZ_SCALE, make_sampler
from gaussiananything_tpu_torch.cli.sample import (ReleaseModels,
                                                   sample_request)
from gaussiananything_tpu_torch.config import RenderConfig
from gaussiananything_tpu_torch.data.synthetic import (make_object,
                                                       render_scene_views)
from gaussiananything_tpu_torch.models.conditioner import ImageConditioner
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
from test_torch_models import carry, randomize

torch.set_num_threads(2)

W, DEPTH, HEADS, K, ZC, IMG = 128, 2, 2, 12, 10, 56
RES, MPT, CHUNK = 32, 256, 64
STEPS, CFG = 4, 4.5


@pytest.fixture(scope="module")
def cascade():
    r = np.random.default_rng(0)
    img = r.uniform(size=(1, 3, 64, 64)).astype(np.float32)
    jimg = jnp.asarray(img)
    cond = JImageConditioner(width=W, depth=DEPTH, heads=HEADS, img_size=IMG,
                             backbone="dinov2")
    pc = randomize(cond, 1, jimg)
    c0 = cond.apply(pc, jimg)
    dits, pds = [], []
    for stage, ch in ((1, 3), (2, ZC)):
        d = JPointDiT(in_channels=ch, width=W, depth=DEPTH, heads=HEADS,
                      cond_dim=W, vector_dim=W, use_xyz_pe=(stage == 2),
                      release_parity=True)
        kw = dict(xyz=jnp.zeros((1, K, 3))) if stage == 2 else {}
        dits.append(d)
        pds.append(randomize(d, 1 + stage, jnp.zeros((1, K, ch)),
                             jnp.zeros((1,)), c0.crossattn, c0.vector, **kw))
    vae = JPointVAE(latent_num=K, z_channels=ZC, decoder_width=W,
                    decoder_depth=DEPTH, decoder_heads=HEADS,
                    up_factors=(8, 4, 3), up_depths=(2, 1, 1),
                    release_parity=True)
    pv = randomize(vae, 4, jnp.zeros((1, K, ZC)), jnp.zeros((1, K, 3)),
                   method=JPointVAE.decode)

    # the JAX cascade, as cli/sample.py runs it
    key = jax.random.PRNGKey(7)
    fm1 = JFMConfig(stage=1, cfg_scale=CFG, num_steps=STEPS, sampler="euler")
    fm2 = JFMConfig(stage=2, cfg_scale=CFG, num_steps=STEPS, sampler="euler")
    xyz_n = make_sampler(dits[0], cond, fm1, (K, 3))(pds[0], pc, jimg, key)
    xyz = np.clip(np.asarray(xyz_n[0]) * XYZ_SCALE, -0.45, 0.45)
    kl = make_sampler(dits[1], cond, fm2, (K, ZC))(
        pds[1], pc, jimg, key, xyz=jnp.asarray(xyz)[None] / 0.45)
    lods = jax.jit(functools.partial(vae.apply, method=JPointVAE.decode))(
        pv, kl, jnp.asarray(xyz)[None])
    sweep = jcameras.uni_mesh_path(8)[:8]
    cam = jcameras.pose_to_gs_camera(jnp.asarray(sweep))
    maps = jrender_multiview(
        lods[-1], cam["cam_view"][None], cam["cam_view_proj"][None],
        jnp.broadcast_to(cam["tanfov"][None], (1, 8)), jnp.ones((1, 8, 3)),
        RES, 16, MPT, CHUNK, 4, impl="xla")
    ref = {"xyz_n": xyz_n, "xyz": xyz, "kl": kl, "lods": lods,
           "render": maps}

    # the port, on the same weights and noise
    models = ReleaseModels(
        cond=carry(pc, ImageConditioner(width=W, depth=DEPTH, heads=HEADS,
                                        img_size=IMG)),
        dit1=carry(pds[0], PointDiT(in_channels=3, width=W, depth=DEPTH,
                                    heads=HEADS, cond_dim=W, vector_dim=W)),
        dit2=carry(pds[1], PointDiT(in_channels=ZC, width=W, depth=DEPTH,
                                    heads=HEADS, cond_dim=W, vector_dim=W,
                                    use_xyz_pe=True)),
        vae=carry(pv, PointVAE(latent_num=K, z_channels=ZC, decoder_width=W,
                               decoder_depth=DEPTH, decoder_heads=HEADS)))
    x0_1 = torch.from_numpy(np.array(jax.random.normal(key, (1, K, 3))))
    x0_2 = torch.from_numpy(np.array(jax.random.normal(key, (1, K, ZC))))
    got = sample_request(
        models, torch.from_numpy(img),
        FMConfig(stage=1, cfg_scale=CFG, num_steps=STEPS, sampler="euler"),
        FMConfig(stage=2, cfg_scale=CFG, num_steps=STEPS, sampler="euler"),
        RenderConfig(output_size=RES, max_per_tile=MPT, chunk=CHUNK),
        x0_stage1=x0_1, x0_stage2=x0_2, log=lambda s: None)
    return got, ref


def test_stage_outputs(cascade):
    got, ref = cascade
    for k in ("xyz_n", "xyz", "kl"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r,
                                   atol=3e-4 * float(np.abs(r).max()),
                                   err_msg=k)


def test_lods(cascade):
    got, ref = cascade
    assert [g.shape for g in got["lods"]] == [(1, K * m, 13)
                                              for m in (1, 8, 32, 96)]
    for g, r in zip(got["lods"], ref["lods"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)


def test_rendered_maps(cascade):
    got, ref = cascade
    assert set(got["render"]) == set(ref["render"])
    for k, r in ref["render"].items():
        g = got["render"][k].numpy()
        assert g.shape == r.shape == (1, 8) + r.shape[2:], k
        d = np.abs(g - np.asarray(r))
        assert np.quantile(d, 0.999) <= 2e-3 and d.mean() <= 1e-4, \
            (k, float(np.quantile(d, 0.999)), float(d.mean()))
    assert float(got["render"]["alpha"].max()) > 0


def test_demo_conditioning_render():
    """The demo conditioning image: a 512-splat object rendered at the
    nearest multiple of 16 and bicubic-resized (here 64 → 56)."""
    pose = jcameras.generate_input_camera(1.8, [(20, 30)])
    ref = jrender_scene_views(jmake_object(7, n=512), pose, IMG)
    got = render_scene_views(make_object(7, n=512), pose, IMG)
    for k in ("image", "alpha", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
