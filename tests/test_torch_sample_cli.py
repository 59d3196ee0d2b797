"""The port's sampling CLI (`cli/sample.py`) at `--preset demo-e2e --steps
2` on the CPU: stage 1 alone, `--text`, `--image-dir`, `--bf16`, `--mesh`,
and `--stage*-ckpt`/`--vae-ckpt` from npz files the JAX package writes
(`restore_inference_params` gives the tensors JAX's gives, carried by
`from_jax_params`), a port training checkpoint's EMA; and `sample_request`
against the JAX cascade of `cli/sample.py` on the same weights and noise,
for the t23d release layout and the JAX package's own presets' layout.

Tolerances as `tests/test_torch_cascade.py`: sampled latents 3e-4 of their
largest |value|, the decoded LoDs atol 1e-3.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussiananything_tpu.config import preset as jpreset
from gaussiananything_tpu.models import conditioner as jcond
from gaussiananything_tpu.models import dit as jdit
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.train.fm_trainer import FMConfig as JFMConfig
from gaussiananything_tpu.train.fm_trainer import XYZ_SCALE, make_sampler
from gaussiananything_tpu.train.state import \
    restore_inference_params as jrestore
from gaussiananything_tpu.utils.param_io import \
    save_params_npz as jsave_params_npz
from gaussiananything_tpu_torch.cli import sample
from gaussiananything_tpu_torch.config import RenderConfig, preset
from gaussiananything_tpu_torch.models import conditioner as cond
from gaussiananything_tpu_torch.models import dit
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.render.ply_io import (load_2dgs_ply,
                                                      load_pointcloud_ply)
from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    restore_inference_params,
                                                    save_checkpoint)
from gaussiananything_tpu_torch.utils.param_io import from_jax_params
from test_torch_models import carry, randomize

torch.set_num_threads(2)
BASE = ["--preset", "demo-e2e", "--steps", "2", "--device", "cpu"]


def _run(tmp_path, *extra):
    out = str(tmp_path / "out")
    return sample.main(BASE + ["--out", out, *extra]), out


def test_stage1_only(tmp_path):
    (res,), out = _run(tmp_path)
    K = preset("demo-e2e").vae.latent_num
    assert sorted(os.listdir(out)) == ["stage1_0.glb", "stage1_0.ply"]
    assert "lods" not in res and res["xyz_n"].shape == (1, K, 3)
    xyz, _ = load_pointcloud_ply(os.path.join(out, "stage1_0.ply"))
    np.testing.assert_allclose(xyz, res["xyz"].numpy(), atol=1e-7)


def test_text_full(tmp_path, capsys):
    (res,), out = _run(tmp_path, "--text", "a red chair", "--full")
    assert {"gaussians_0.ply", "turntable_0.png"} <= set(os.listdir(out))
    g = load_2dgs_ply(os.path.join(out, "gaussians_0.ply"))
    np.testing.assert_allclose(g, res["lods"][-1][0].numpy(), atol=1e-5)
    assert "WARNING" not in capsys.readouterr().out   # bytes: no warning


def test_image_dir_bf16(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for name, seed in (("b.png", 1), ("a.png", 0)):
        r = np.random.default_rng(seed)
        a = np.full((80, 72, 3), 40, np.uint8)
        a[20:60, 16:50] = r.integers(120, 255, (40, 34, 3))
        Image.fromarray(a).save(img_dir / name)
    (res,), out = _run(tmp_path, "--image-dir", str(img_dir), "--full",
                       "--bf16")
    assert all(x.dtype == torch.float32 for x in res["lods"])
    assert torch.isfinite(res["lods"][-1]).all()
    assert "turntable_0.png" in os.listdir(out)


def test_mesh(tmp_path, monkeypatch):
    """--mesh with the sweep cut to 4 azimuths (20 views) at 64² and D 32
    (the CLI's 176³ over 50 views at 256² is the card's)."""
    monkeypatch.setattr(sample, "MESH", dict(resolution=32, n_views=4,
                                             render_size=64))
    (res,), out = _run(tmp_path, "--full", "--mesh")
    verts, faces, vcol = res["mesh"]
    assert os.path.getsize(os.path.join(out, "mesh_0.glb")) > 0
    assert faces.max() < len(verts) and vcol.shape == verts.shape
    assert {"mesh render", "mesh integrate", "mesh surface nets"} <= \
        set(res["timings"])


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """The JAX CLI's demo-e2e modules, seeded, written by the JAX
    package's `save_params_npz` → ({name: path}, {name: params})."""
    cfg = jpreset("demo-e2e")
    K, zc, w = cfg.vae.latent_num, cfg.vae.z_channels, cfg.dit.cond_width
    img = jnp.zeros((1, 3, cfg.dit.cond_img_size, cfg.dit.cond_img_size))
    c = jcond.ImageConditioner(width=w, depth=cfg.dit.cond_depth,
                               heads=cfg.dit.cond_heads,
                               img_size=cfg.dit.cond_img_size)
    ctx = jnp.zeros((1, 8, w))
    vec = jnp.zeros((1, w))
    mods = {
        "cond": (c, (img,), {}),
        "stage1": (jdit.stage1_dit("S", cond_dim=w, vector_dim=w),
                   (jnp.zeros((1, K, 3)), jnp.zeros((1,)), ctx, vec), {}),
        "stage2": (jdit.stage2_dit("S", z_channels=zc, cond_dim=w,
                                   vector_dim=w),
                   (jnp.zeros((1, K, zc)), jnp.zeros((1,)), ctx, vec,
                    jnp.zeros((1, K, 3))), {}),
        "vae": (JPointVAE.from_config(cfg.vae),
                (jnp.zeros((1, K, zc)), jnp.zeros((1, K, 3))),
                dict(method=JPointVAE.decode)),
    }
    d = tmp_path_factory.mktemp("jax_ckpts")
    paths, params = {}, {}
    for i, (name, (m, args, kw)) in enumerate(mods.items()):
        params[name] = randomize(m, 20 + i, *args, **kw)
        paths[name] = str(d / f"{name}.npz")
        jsave_params_npz(paths[name], params[name])
    return paths, params


def test_restore_matches_jax(tmp_path, jax_ckpts):
    paths, params = jax_ckpts
    args = sample.parse_args(BASE + [
        "--stage1-ckpt", paths["stage1"], "--stage1-cond-ckpt",
        paths["cond"], "--stage2-ckpt", paths["stage2"], "--vae-ckpt",
        paths["vae"], "--stage2-cond-ckpt", paths["cond"]])
    models = sample.build_models(args, preset("demo-e2e"), "cpu")
    for name, mod in (("cond", models.cond), ("stage1", models.dit1),
                      ("stage2", models.dit2), ("vae", models.vae),
                      ("cond", models.cond2)):
        ref = from_jax_params(jrestore(paths[name], params[name]), mod)
        got = mod.state_dict()
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (name, k)
    # a VAE checkpoint turns stage 2 on, as --full does; nothing else does
    cfg = preset("demo-e2e")
    on = sample.build_models(sample.parse_args(
        BASE + ["--vae-ckpt", paths["vae"]]), cfg, "cpu")
    assert on.dit2 is not None and on.vae is not None
    off = sample.build_models(sample.parse_args(
        BASE + ["--stage1-ckpt", paths["stage1"]]), cfg, "cpu")
    assert off.dit2 is None and off.vae is None


def test_restore_port_checkpoint(tmp_path):
    """A port training checkpoint restores its EMA weights; a decoder-only
    VAE takes the decoder entries of a trained VAE with its encoder."""
    torch.manual_seed(0)
    kw = dict(latent_num=12, z_channels=4, decoder_width=64,
              decoder_depth=1, decoder_heads=2, up_factors=(2,),
              up_depths=(1,), release_parity=False, encoder_width=32)
    trained = PointVAE(with_encoder=True, **kw)
    state = TrainState.create(trained)
    for v in state.ema.values():
        v.add_(0.25)
    save_checkpoint(str(tmp_path / "ckpt"), state)
    decoder = restore_inference_params(str(tmp_path / "ckpt"),
                                       PointVAE(**kw))
    for k, v in decoder.state_dict().items():
        assert torch.equal(v, state.ema[k]), k
    assert restore_inference_params(None, decoder) is decoder
    with pytest.raises(FileNotFoundError):
        restore_inference_params(str(tmp_path / "none"), decoder)


# ------------------------------------------------ sample_request vs JAX

W, K, ZC, STEPS = 64, 12, 10, 2


def _jax_cascade(kind):
    """(JAX results, port ReleaseModels, conditioning input, noise)."""
    r = np.random.default_rng(3)
    if kind == "t23d":
        jc = jcond.TextConditioner(width=W, depth=1, heads=4,
                                   backbone="openclip")
        inp = jcond.tokenize_bytes(["a red chair"])
        c = cond.TextConditioner(width=W, depth=1, heads=4,
                                 backbone="openclip")
        dk = dict(width=W, depth=1, heads=4, cond_dim=W, vector_dim=W,
                  release_parity=True, variant="text")
        vae_kw = dict(latent_num=K, z_channels=ZC, decoder_width=W,
                      decoder_depth=2, decoder_heads=4, up_factors=(2,),
                      up_depths=(1,), release_parity=True)
        scale = 0.45
    else:
        jc = jcond.ImageConditioner(width=W, depth=1, heads=4, img_size=56)
        inp = r.uniform(size=(1, 3, 56, 56)).astype(np.float32)
        c = cond.ImageConditioner(width=W, depth=1, heads=4, img_size=56,
                                  backbone="scratch")
        dk = dict(width=W, depth=1, heads=4, cond_dim=W, vector_dim=W,
                  release_parity=False)
        vae_kw = dict(latent_num=K, z_channels=ZC, decoder_width=W,
                      decoder_depth=2, decoder_heads=4, up_factors=(2,),
                      up_depths=(1,), release_parity=False)
        scale = 1.0
    jinp = jnp.asarray(inp)
    pc = randomize(jc, 30, jinp)
    c0 = jc.apply(pc, jinp)
    jd1 = jdit.PointDiT(in_channels=3, use_xyz_pe=False, **dk)
    jd2 = jdit.PointDiT(in_channels=ZC, use_xyz_pe=True, **dk)
    p1 = randomize(jd1, 31, jnp.zeros((1, K, 3)), jnp.zeros((1,)),
                   c0.crossattn, c0.vector)
    p2 = randomize(jd2, 32, jnp.zeros((1, K, ZC)), jnp.zeros((1,)),
                   c0.crossattn, c0.vector, xyz=jnp.zeros((1, K, 3)))
    jv = JPointVAE(**vae_kw)
    pv = randomize(jv, 33, jnp.zeros((1, K, ZC)), jnp.zeros((1, K, 3)),
                   method=JPointVAE.decode)
    key = jax.random.PRNGKey(11)
    fm1 = JFMConfig(stage=1, cfg_scale=4.5, num_steps=STEPS,
                    sampler="euler")
    fm2 = JFMConfig(stage=2, cfg_scale=4.5, num_steps=STEPS,
                    sampler="euler")
    xyz_n = make_sampler(jd1, jc, fm1, (K, 3))(p1, pc, jinp, key)
    xyz = np.clip(np.asarray(xyz_n[0]) * XYZ_SCALE, -0.45, 0.45)
    kl = make_sampler(jd2, jc, fm2, (K, ZC))(
        p2, pc, jinp, key, xyz=jnp.asarray(xyz)[None] / scale)
    lods = jax.jit(functools.partial(jv.apply, method=JPointVAE.decode))(
        pv, kl, jnp.asarray(xyz)[None])
    ref = {"xyz_n": xyz_n, "xyz": xyz, "kl": kl, "lods": lods}
    vae_kw.pop("release_parity")
    models = sample.ReleaseModels(
        cond=carry(pc, c),
        dit1=carry(p1, dit.PointDiT(in_channels=3, use_xyz_pe=False, **dk)),
        dit2=carry(p2, dit.PointDiT(in_channels=ZC, use_xyz_pe=True, **dk)),
        vae=carry(pv, PointVAE(release_parity=dk["release_parity"],
                               **vae_kw)),
        xyz_cond_scale=scale)
    noise = [torch.from_numpy(np.array(jax.random.normal(key, (1, K, ch))))
             for ch in (3, ZC)]
    x_in = torch.from_numpy(np.asarray(inp))
    return ref, models, (x_in.long() if kind == "t23d" else x_in), noise


@pytest.mark.parametrize("kind", ["t23d", "preset"])
def test_sample_request_matches_jax(kind):
    ref, models, x_in, (n1, n2) = _jax_cascade(kind)
    fm1 = FMConfig(stage=1, cfg_scale=4.5, num_steps=STEPS, sampler="euler")
    fm2 = FMConfig(stage=2, cfg_scale=4.5, num_steps=STEPS, sampler="euler")
    got = sample.sample_request(
        models, x_in, fm1, fm2,
        RenderConfig(output_size=32, max_per_tile=256, chunk=64),
        x0_stage1=n1, x0_stage2=n2, log=lambda s: None)
    for k in ("xyz_n", "xyz", "kl"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy().reshape(r.shape), r,
                                   atol=3e-4 * float(np.abs(r).max()),
                                   err_msg=k)
    for g, r in zip(got["lods"], ref["lods"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)
    assert got["render"]["image"].shape == (1, 8, 3, 32, 32)
