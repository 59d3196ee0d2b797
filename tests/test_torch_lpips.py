"""The port's VGG16-LPIPS against the JAX package on the CPU: seeded
weights in the pip-`lpips` state-dict layout go through the JAX package's
converter and `save_params_npz`; the port reads that npz with its own
`load_params_npz` and `from_jax_params`, as `cli/train_vae.py
--lpips-npz` does."""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.train import losses as JL
from gaussiananything_tpu.utils import param_io as jparam_io
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.utils import param_io

torch.set_num_threads(2)

# (torchvision conv index, in, out, pip-lpips slice)
_CONVS = [(0, 3, 64, 1), (2, 64, 64, 1), (5, 64, 128, 2), (7, 128, 128, 2),
          (10, 128, 256, 3), (12, 256, 256, 3), (14, 256, 256, 3),
          (17, 256, 512, 4), (19, 512, 512, 4), (21, 512, 512, 4),
          (24, 512, 512, 5), (26, 512, 512, 5), (28, 512, 512, 5)]


def _lpips_state_dict(seed):
    """A pip-`lpips` VGG state dict (`net.sliceS.N.*`, `linK.model.1`)
    with seeded weights."""
    r = np.random.default_rng(seed)
    sd = {}
    for idx, cin, cout, sl in _CONVS:
        sd[f"net.slice{sl}.{idx}.weight"] = \
            (r.standard_normal((cout, cin, 3, 3)) * 0.05).astype(np.float32)
        sd[f"net.slice{sl}.{idx}.bias"] = \
            (r.standard_normal(cout) * 0.05).astype(np.float32)
    for k, ch in enumerate(L.LPIPS_CHANNELS):
        sd[f"lin{k}.model.1.weight"] = np.abs(
            r.standard_normal((1, ch, 1, 1)) * 0.1).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX tree and the npz JAX's `save_params_npz` wrote of it."""
    params = jparam_io.convert_lpips_vgg(_lpips_state_dict(0),
                                         JL.init_lpips_template(32))
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    jparam_io.save_params_npz(path, params)
    return params, path


def _port_net(path):
    net = L.VGGLPIPS()
    net.load_state_dict(param_io.from_jax_params(
        param_io.load_params_npz(path), net))
    return net.requires_grad_(False)


def _images(seed, n=2, res=32):
    r = np.random.default_rng(seed)
    return (r.random((n, 3, res, res)).astype(np.float32),
            r.random((n, 3, res, res)).astype(np.float32))


def test_load_params_npz_reads_jax_layout(weights):
    """The port's reader gives JAX's tree leaf for leaf, and its writer
    writes the same keys."""
    params, path = weights
    tree = param_io.load_params_npz(path)
    want = jparam_io.flatten_dict(params, sep="/")
    got = param_io._flatten(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    again = path[:-4] + "_port.npz"
    param_io.save_params_npz(again, tree)
    with np.load(again) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)


@pytest.mark.parametrize("res", [32, 48])
def test_lpips_vgg_matches_jax(weights, res):
    """Value at rtol 1e-4 / atol 1e-5 (tests/test_lpips.py's tolerance);
    48 is not a multiple of 32, so the last pools floor."""
    params, path = weights
    a, b = _images(1, res=res)
    ref = float(JL.lpips_vgg(jnp.asarray(a), jnp.asarray(b), params))
    got = float(L.lpips_vgg(torch.from_numpy(a), torch.from_numpy(b),
                            _port_net(path)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_lpips_vgg_gradient_matches_jax(weights):
    """The input gradient, per element within 1e-3 of max|g| (fp32
    convolutions forward and back through thirteen layers; the value
    itself is held to 1e-4 above)."""
    params, path = weights
    a, b = _images(2)
    ref = np.asarray(jax.grad(lambda x: JL.lpips_vgg(
        x, jnp.asarray(b), params))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    got, = torch.autograd.grad(L.lpips_vgg(x, torch.from_numpy(b),
                                           _port_net(path)), x)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3 * scale)


def test_perceptual_loss_dispatches_to_lpips(weights):
    """`perceptual_loss` with a `VGGLPIPS` is `lpips_vgg`, as JAX's is with
    LPIPS weights; identical inputs give 0."""
    params, path = weights
    net = _port_net(path)
    a, b = (torch.from_numpy(x) for x in _images(3, n=1))
    assert float(L.perceptual_loss(a, b, net)) == \
        float(L.lpips_vgg(a, b, net))
    np.testing.assert_allclose(
        float(L.perceptual_loss(a, b, net)),
        float(JL.perceptual_loss(jnp.asarray(a.numpy()),
                                 jnp.asarray(b.numpy()), params=params)),
        rtol=1e-4, atol=1e-5)
    assert abs(float(L.lpips_vgg(a, a, net))) < 1e-6
    assert float(L.perceptual_loss(a, b)) != float(L.lpips_vgg(a, b, net))


def test_vgg_trunk_layout():
    """torchvision's indices: convs where `features.N` says, the taps after
    relus 2, 7, 14, 21, 28 at 1, 1/2, 1/4, 1/8, 1/16 of the size."""
    net = L.VGG16Features()
    convs = [i for i, m in enumerate(net.features)
             if isinstance(m, torch.nn.Conv2d)]
    assert convs == [idx for idx, *_ in _CONVS]
    with torch.no_grad():
        feats = net(torch.zeros((1, 3, 32, 32)))
    assert [tuple(f.shape[1:]) for f in feats] == [
        (64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4), (512, 2, 2)]


def test_train_cli_reads_the_lpips_npz(weights, tmp_path, capsys):
    """`--lpips-npz` loads the file JAX wrote and trains with it; a file
    that lacks a layer is refused."""
    from gaussiananything_tpu_torch.cli import train_vae
    from gaussiananything_tpu_torch.config import preset
    cfg = preset("demo-e2e")
    cfg.data.resolution, cfg.data.n_points = 32, 64
    cfg.render.lod_resolutions = (16, 32)
    cfg.vae.latent_num, cfg.vae.decoder_width = 12, 64
    cfg.vae.encoder_width = 64
    cfg.optim.batch_size, cfg.optim.warmup_steps = 1, 1
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    args = ["--config", str(path), "--steps", "1", "--device", "cpu"]
    res = train_vae.main(args + ["--logdir", str(tmp_path / "a"),
                                 "--lpips-npz", weights[1]])
    assert "loaded VGG-LPIPS weights" in capsys.readouterr().out
    lg = res["logs"][0]
    assert sum(lg[f"lpips_lod{i}"] > 0 for i in range(2)) == 1
    assert all(np.isfinite(v) for v in lg.values())
    tree = param_io.load_params_npz(weights[1])
    del tree["params"]["lins.4"]
    bad = str(tmp_path / "bad.npz")
    param_io.save_params_npz(bad, tree)
    with pytest.raises(KeyError, match="lins.4"):
        train_vae.main(args + ["--logdir", str(tmp_path / "b"),
                               "--lpips-npz", bad])
