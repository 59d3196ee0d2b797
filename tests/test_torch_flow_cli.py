"""The generator's training CLIs of the port on the CPU at the `demo-e2e`
preset: `cli/extract_latents.py` against the JAX CLI's npz files on the
same VAE weights and KL noise, the t23d round trip of
`tests/test_import_cli.py:49` (extraction → `train_flow --cond text` →
checkpoint → text-conditioned sampling), three straight steps against two
steps and a `--resume` to the third (the data stream goes on where the
checkpointed run stopped), and the rounding of the uint8 cache of the
conditioning views against the JAX CLI's truncation."""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.cli import extract_latents as jextract
from gaussiananything_tpu.config import preset as jpreset
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.utils.param_io import save_params_npz
from gaussiananything_tpu_torch.cli import extract_latents, train_flow
from gaussiananything_tpu_torch.config import preset
from gaussiananything_tpu_torch.models.conditioner import (TextConditioner,
                                                           tokenize_bytes)
from gaussiananything_tpu_torch.models.dit import stage1_dit
from gaussiananything_tpu_torch.train.fm_trainer import FMConfig, make_sampler
from gaussiananything_tpu_torch.train.state import restore_inference_params
from test_torch_models import randomize

torch.set_num_threads(2)

N_LAT = 2


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """Both CLIs over the same N_LAT procedural instances with the same
    VAE weights (seeded values in a JAX-layout npz, `--ckpt` of both)
    and the JAX CLI's KL noise handed to the port."""
    root = tmp_path_factory.mktemp("extract")
    cfg = jpreset("demo-e2e")
    res = cfg.data.resolution
    imgs = jnp.zeros((1, cfg.data.n_views_in, 15, res, res))
    params = randomize(JPointVAE.from_config(cfg.vae), 5, imgs,
                       jnp.zeros((1, cfg.data.n_points, 3)),
                       jax.random.PRNGKey(0))
    ckpt = str(root / "vae.npz")
    save_params_npz(ckpt, params)
    jextract.main(["--out", str(root / "jax"), "--num", str(N_LAT),
                   "--ckpt", ckpt])
    shape = (1, cfg.vae.latent_num, cfg.vae.z_channels)
    noise = [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), i), shape)))
        for i in range(N_LAT)]
    res = extract_latents.main(["--out", str(root / "port"), "--num",
                                str(N_LAT), "--ckpt", ckpt, "--device",
                                "cpu"], noise=noise)
    return root, res


def test_extract_latents_matches_jax(extracted):
    """Equal file names, captions and FPS anchors (integer-equal FPS on
    the same point cloud); the KL sample on the same noise within the
    encoder's tolerance (`tests/test_torch_encoder.py`: atol 1e-4). The
    conditioning view renders through each package's own rasterizer and
    is held within the rasterizer's golden image tolerance, 2e-3
    (`tests/test_golden_parity.py`), with at most 0.1% of its values
    beyond 2e-5: an α ≥ 1/255 test that flips on the last ulp moves a few
    pixels (12 of 37,632 at 3 instances) by up to 7e-4."""
    root, res = extracted
    names = sorted(os.listdir(root / "jax"))
    assert names == sorted(os.listdir(root / "port")) == [
        f"{i:05d}.npz" for i in range(N_LAT)]
    assert [os.path.basename(f) for f in res["files"]] == names
    assert len(res["seconds"]) == N_LAT
    for name in names:
        with np.load(root / "jax" / name) as j, \
                np.load(root / "port" / name) as p:
            assert sorted(j.files) == sorted(p.files)
            assert str(p["caption"]) == str(j["caption"]) != ""
            np.testing.assert_array_equal(p["query_pcd_xyz"],
                                          j["query_pcd_xyz"])
            assert p["cond"].shape == j["cond"].shape == (3, 112, 112)
            np.testing.assert_allclose(p["cond"], j["cond"], atol=2e-3)
            assert (np.abs(p["cond"] - j["cond"]) > 2e-5).mean() < 1e-3
            assert p["latent_normalized"].shape == (64, 4)
            np.testing.assert_allclose(p["latent_normalized"],
                                       j["latent_normalized"], atol=1e-4,
                                       rtol=1e-4)


def test_t23d_training_roundtrip(extracted, tmp_path):
    """Captions flow from the extraction through `train_flow --cond text`
    (byte tokens, ucg dropout) to a checkpoint that drives text-conditioned
    sampling (`tests/test_import_cli.py:49`)."""
    root, _ = extracted
    log = str(tmp_path / "log")
    res = train_flow.main(["--preset", "demo-e2e", "--stage", "1",
                           "--steps", "2", "--batch", "2", "--latent-dir",
                           str(root / "port"), "--cond", "text", "--logdir",
                           log, "--device", "cpu"])
    assert len(res["logs"]) == 2 and res["state"].step == 2
    assert os.path.isdir(os.path.join(log, "ckpt"))
    cfg = preset("demo-e2e")
    dit = stage1_dit(size=cfg.dit.size, cond_dim=cfg.dit.cond_width,
                     vector_dim=cfg.dit.cond_width)
    cond = TextConditioner(width=cfg.dit.cond_width,
                           depth=cfg.dit.cond_depth,
                           heads=cfg.dit.cond_heads)
    restore_inference_params(os.path.join(log, "ckpt"), dit)
    restore_inference_params(os.path.join(log, "ckpt_cond"), cond)
    for k, v in cond.state_dict().items():
        assert torch.equal(v, res["cond_state"].ema[k]), k
    K = cfg.vae.latent_num
    ids = torch.from_numpy(tokenize_bytes(["a red sphere"])).long()
    xyz = make_sampler(dit.eval(), cond.eval(),
                       FMConfig(stage=1, cfg_scale=2.0, num_steps=4,
                                sampler="euler"), (K, 3))(
        ids, generator=torch.Generator().manual_seed(0))
    assert xyz.shape == (1, K, 3) and bool(torch.isfinite(xyz).all())


def test_extract_latents_from_a_dataset_matches_jax(extracted, tmp_path):
    """`--data-dir`: both CLIs draw the same instance and views from a
    packed dataset (the port's `export_synthetic_dataset`, a caption
    sidecar written beside one instance) and write the same anchors and
    caption, the view within 1e-6 (the same stored pixels, resized) and
    the latent within the encoder's 1e-4."""
    from gaussiananything_tpu_torch.data.gbuffer import \
        export_synthetic_dataset
    root, _ = extracted
    data = str(tmp_path / "data")
    export_synthetic_dataset(data, n_instances=2, n_views=4, res=128,
                             n_splats=512)
    with open(os.path.join(data, "00001.caption.txt"), "w") as f:
        f.write("a packed test object")
    ckpt = str(root / "vae.npz")
    jextract.main(["--out", str(tmp_path / "jax"), "--num", "1", "--ckpt",
                   ckpt, "--data-dir", data])
    cfg = preset("demo-e2e")
    noise = [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), 0),
        (1, cfg.vae.latent_num, cfg.vae.z_channels))))]
    extract_latents.main(["--out", str(tmp_path / "port"), "--num", "1",
                          "--ckpt", ckpt, "--data-dir", data, "--device",
                          "cpu"], noise=noise)
    with np.load(tmp_path / "jax" / "00000.npz") as j, \
            np.load(tmp_path / "port" / "00000.npz") as p:
        assert str(p["caption"]) == str(j["caption"])
        np.testing.assert_array_equal(p["query_pcd_xyz"], j["query_pcd_xyz"])
        np.testing.assert_allclose(p["cond"], j["cond"], atol=1e-6)
        np.testing.assert_allclose(p["latent_normalized"],
                                   j["latent_normalized"], atol=1e-4,
                                   rtol=1e-4)


def test_bpe_trains_the_openclip_tower(extracted, tmp_path):
    """`--bpe VOCAB`: CLIP BPE ids from a merges file the test writes
    (`tests/test_torch_text.py`), fed to the OpenCLIP text tower, whose
    embedding holds them."""
    from gaussiananything_tpu_torch.models.openclip_text import \
        OpenClipTextTower
    root, _ = extracted
    merges = tmp_path / "bpe.txt"
    merges.write_text("#version: 0.2\nr e\nre d</w>\nc u\ncu b\n")
    res = train_flow.main(["--preset", "demo-e2e", "--steps", "1",
                           "--batch", "2", "--latent-dir", str(root / "port"),
                           "--cond", "text", "--bpe", str(merges),
                           "--logdir", str(tmp_path / "log"), "--device",
                           "cpu"])
    assert isinstance(res["cond"].text, OpenClipTextTower)
    assert res["state"].step == 1 and all(
        np.isfinite(v) for v in res["logs"][0].values())


N_RESUME_LAT = 6


def _resume_args(lat, log, steps, cfg_path):
    return ["--config", cfg_path, "--steps", str(steps), "--batch", "2",
            "--accum", "2", "--latent-dir", lat, "--logdir", log,
            "--eval-every", "2", "--save-every", "2", "--device", "cpu"]


def test_resume_continues_the_stream(tmp_path):
    """Three straight steps (with an evaluation after step 2, which draws
    a batch of its own) and two steps plus `--resume` to the third end in
    the same parameters, moments, EMA and conditioner state, bit for bit,
    and the same third-step losses. The JAX CLI restarts the stream on
    resume: its third step would train on draw 1 where the straight run
    trains on draw 4, and those two draws differ here."""
    res = extract_latents.main(["--out", str(tmp_path / "lat"), "--num",
                                str(N_RESUME_LAT), "--device", "cpu"])
    lat = os.path.dirname(res["files"][0])
    cfg = preset("demo-e2e")
    cfg.transport.num_steps = 2          # the evaluation's sampler
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    straight = train_flow.main(_resume_args(lat, str(tmp_path / "a"), 3,
                                            cfg_path))
    first = train_flow.main(_resume_args(lat, str(tmp_path / "b"), 2,
                                         cfg_path))
    resumed = train_flow.main(
        _resume_args(lat, str(tmp_path / "b"), 3, cfg_path)
        + ["--resume", str(tmp_path / "b" / "ckpt")])
    assert len(first["logs"]) == 2 and len(resumed["logs"]) == 1
    assert resumed["logs"][0] == straight["logs"][2]
    assert len(straight["evals"]) == len(first["evals"]) == 1
    for a, b in ((straight["state"], resumed["state"]),
                 (straight["cond_state"], resumed["cond_state"])):
        assert a.step == b.step == 3
        for tree in ("params", "mu", "nu", "ema"):
            ta, tb = getattr(a, tree), getattr(b, tree)
            assert set(ta) == set(tb)
            for k in ta:
                assert torch.equal(ta[k], tb[k]), (tree, k)
    draws = np.random.default_rng(cfg.seed)
    idx = [draws.integers(0, N_RESUME_LAT, 2) for _ in range(5)]
    assert not np.array_equal(idx[1], idx[4])


def test_uint8_cache_rounds():
    """The port rounds each conditioning value to the nearest 1/255 where
    the JAX CLI truncates (`cli/train_flow.py:154`): at most 1/255 apart,
    the port within half of it of the value, and values outside [0, 1]
    refused."""
    c = np.random.default_rng(0).uniform(0, 1, (4, 3, 16, 16)).astype(
        np.float32)
    c[0, 0, 0, :3] = [0.0, 1.0, 1.0 + 1e-7]
    got = train_flow.quantize_cond(c)
    jax_cache = np.clip(c * 255.0, 0, 255).astype(np.uint8)
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.float64) - jax_cache) / 255.0
    assert d.max() <= 1 / 255 + 1e-12 and (d > 0).mean() > 0.3
    assert np.abs(got / 255.0 - np.clip(c, 0, 1)).max() <= 0.5 / 255 + 1e-6
    assert np.abs(jax_cache / 255.0 - c).max() > 0.5 / 255
    for bad in (-0.01, 1.01):
        c[1, 0, 0, 0] = bad
        with pytest.raises(ValueError, match="not \\[0, 1\\]"):
            train_flow.quantize_cond(c)


def test_clis_refuse_the_jax_platform_flag():
    for mod, extra in ((train_flow, []), (extract_latents,
                                          ["--out", "unused"])):
        with pytest.raises(SystemExit):
            mod.main(["--platform", "cpu"] + extra)
