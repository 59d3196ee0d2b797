"""Matting and real images, the port against the JAX package: `u2netp` at
64² (fused map and the 7 side maps) and `matting_alpha` on seeded weights
carried by `from_jax_params`, the full `U2Net`'s names against the torch
source's, `remove_background` (chroma key and U²-Net alpha) and
`resize_foreground`, and `RealImageDataset` on PNGs the test writes.

Tolerances: the networks 1e-4 of the output's scale; `remove_background`
and `resize_foreground` 1e-5 (`tests/test_extras.py:59-66`); the dataset's
arrays, which pass through uint8 and PIL in both packages, 1/255.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussiananything_tpu.data import real as jreal
from gaussiananything_tpu.models import matting as jmatting
from gaussiananything_tpu.utils import param_io as jparam_io
from gaussiananything_tpu_torch.data import real
from gaussiananything_tpu_torch.models import matting
from gaussiananything_tpu_torch.utils.param_io import (from_jax_params,
                                                       save_params_npz)
from test_torch_models import randomize

torch.set_num_threads(2)


def _seeded(jnet, seed, size=64):
    """Seeded values for every parameter ({"params": ...}), with BatchNorm
    statistics that keep the activations in range (a positive variance)."""
    p = randomize(jnet, seed, jnp.zeros((1, size, size, 3)))
    r = np.random.default_rng(seed + 100)

    def fix(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fix(v)
            elif k == "bn_var":
                tree[k] = (0.5 + r.uniform(size=v.shape)).astype(np.float32)
            elif k == "bn_mean":
                tree[k] = (0.1 * r.normal(size=v.shape)).astype(np.float32)
    fix(p)
    return p


@pytest.fixture(scope="module")
def small():
    jnet = jmatting.u2netp()
    params = _seeded(jnet, 0)
    net = matting.u2netp()
    net.load_state_dict(from_jax_params(params, net))
    return jnet, params, net.eval()


def test_u2netp_forward(small):
    jnet, params, net = small
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)) \
        .astype(np.float32)
    ref, ref_sides = jax.jit(functools.partial(jnet.apply,
                                               side_outputs=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got, sides = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                         side_outputs=True)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-4 * scale)
    for g, r in zip(sides, ref_sides):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), atol=1e-4)
    assert 0.0 < float(got.std())       # the seeded net is not saturated
    with pytest.raises(ValueError, match="multiples of 32"):
        net(torch.zeros(1, 3, 48, 48))


def test_full_u2net_names():
    """The port's full U²-Net has exactly the torch source's entries
    (the JAX package's u2net name map, inverted) and shapes."""
    jnet = jmatting.u2net()
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 32, 32, 3))))
    from flax.traverse_util import flatten_dict
    flat = flatten_dict(shapes["params"], sep="/")
    net = matting.u2net()
    sd = net.state_dict()
    names = set()
    for path, v in flat.items():
        parts = path.split("/")
        if parts[0].startswith("side") or parts[0] == "outconv":
            tname = parts[0] + (".weight" if parts[1] == "kernel"
                                else ".bias")
        elif parts[2] == "conv_s1":
            tname = ".".join(parts[:3]) + (".weight" if parts[3] == "kernel"
                                           else ".bias")
        else:
            tname = ".".join(parts[:2]) + ".bn_s1." + {
                "bn_scale": "weight", "bn_bias": "bias",
                "bn_mean": "running_mean", "bn_var": "running_var"}[parts[2]]
        assert jparam_io.u2net_name_map(tname) == path
        assert int(np.prod(v.shape)) == sd[tname].numel(), tname
        names.add(tname)
    assert names == set(sd)


def test_matting_alpha(small):
    jnet, params, net = small
    img = np.random.default_rng(2).uniform(size=(96, 80, 3)) \
        .astype(np.float32)
    ref = np.asarray(jmatting.matting_alpha(params, jnp.asarray(img),
                                            res=64, net=jnet))
    got = matting.matting_alpha(net, torch.from_numpy(img), res=64).numpy()
    assert got.shape == (96, 80)
    np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()))


def _object_image(seed=3, h=64, w=64):
    r = np.random.default_rng(seed)
    img = np.full((h, w, 3), 0.2, np.float32)
    img += 0.01 * r.normal(size=img.shape).astype(np.float32)
    img[18:44, 22:40] = r.uniform(0.5, 1.0, size=(26, 18, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def test_remove_background_chroma_key_and_resize():
    img = _object_image()
    got = real.remove_background(img)
    ref = jreal.remove_background(img)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got[0, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(real.resize_foreground(got),
                               jreal.resize_foreground(ref), atol=1e-5)
    blank = np.ones((16, 16, 3), np.float32)
    assert real.resize_foreground(blank) is blank


def test_remove_background_matting(small, monkeypatch):
    """The U²-Net branch, at 64² for the net (both packages' matting_alpha
    take their module's function at call time)."""
    jnet, params, net = small
    monkeypatch.setattr(jmatting, "matting_alpha",
                        functools.partial(jmatting.matting_alpha, res=64,
                                          net=jnet))
    monkeypatch.setattr(matting, "matting_alpha",
                        functools.partial(matting.matting_alpha, res=64))
    img = _object_image(4)
    ref = jreal.remove_background(img, matting_params=params)
    got = real.remove_background(img, matting_net=net)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_real_image_dataset(tmp_path, small, monkeypatch):
    """PNGs of both kinds of background; the chroma key, and the U²-Net
    from an npz written by the port in the JAX layout."""
    for i, seed in enumerate((5, 6)):
        arr = (_object_image(seed, 72, 60) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img_{i}.png")
    got = real.RealImageDataset(str(tmp_path), img_size=56)
    ref = jreal.RealImageDataset(str(tmp_path), img_size=56)
    assert len(got) == len(ref) == 2 and got.paths == ref.paths
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (3, 56, 56) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1.0 / 255 + 1e-6)

    jnet, params, _ = small
    npz = str(tmp_path / "u2netp.npz")
    save_params_npz(npz, params)
    monkeypatch.setattr(real, "load_matting_net", lambda path, device:
                        _load_u2netp(path))
    monkeypatch.setattr(jmatting, "matting_alpha",
                        functools.partial(jmatting.matting_alpha, res=64,
                                          net=jnet))
    monkeypatch.setattr(matting, "matting_alpha",
                        functools.partial(matting.matting_alpha, res=64))
    got = real.RealImageDataset(str(tmp_path), img_size=56, matting_npz=npz)
    ref = jreal.RealImageDataset(str(tmp_path), img_size=56, matting_npz=npz)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1.0 / 255 + 1e-6)


def _load_u2netp(path):
    from gaussiananything_tpu_torch.utils.param_io import load_params_npz
    net = matting.u2netp()
    net.load_state_dict(from_jax_params(load_params_npz(path), net))
    return net.eval()
