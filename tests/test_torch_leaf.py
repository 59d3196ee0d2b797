"""The port's leaf modules against the JAX package: config, quaternions,
gaussian activation, cameras, the synthetic object, the bicubic resize and
the file writers. Inputs are made from a seed with numpy and given to both.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu import config as jconfig
from gaussiananything_tpu.data.synthetic import make_object as jmake_object
from gaussiananything_tpu.ops.gaussians import \
    activate_gaussians_at as jactivate_at
from gaussiananything_tpu.render import cameras as jcameras
from gaussiananything_tpu.render import ply_io as jply
from gaussiananything_tpu.utils import quaternions as jquat
from gaussiananything_tpu_torch import config
from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.ops.gaussians import (activate_gaussians_at,
                                                      pack_gaussians,
                                                      unpack_gaussians)
from gaussiananything_tpu_torch.render import cameras, ply_io
from gaussiananything_tpu_torch.utils import quaternions
from gaussiananything_tpu_torch.utils.image import resize, save_png

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_release_config_matches():
    """The port's own copy of the config tree holds the same values."""
    for name in ("demo-e2e", "stage1", "vae-release"):
        got = dataclasses.asdict(config.release_config(config.preset(name)))
        ref = dataclasses.asdict(jconfig.release_config(jconfig.preset(name)))
        assert got == ref
    assert config.compute_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        config.compute_dtype("float16")


def test_quaternions():
    """fp32 elementwise math in one order: agree to a few ulp (1e-6)."""
    r = np.random.default_rng(0)
    q = r.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                                   # the NaN-safe zero vector
    np.testing.assert_allclose(quaternions.normalize(t(q)).numpy(),
                               np.asarray(jquat.normalize(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_allclose(
        quaternions.quat_to_rotmat(t(q)).numpy(),
        np.asarray(jquat.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    assert torch.isfinite(quaternions.normalize(t(q))).all()


def test_pack_unpack_gaussians():
    g = t(np.random.default_rng(6).normal(size=(2, 9, 13)))
    s = unpack_gaussians(g)
    assert s.rotation.shape == (2, 9, 4) and s.rgb.shape == (2, 9, 3)
    torch.testing.assert_close(pack_gaussians(s), g, atol=0, rtol=0)
    with pytest.raises(ValueError):
        unpack_gaussians(g[..., :12])


def test_activate_gaussians_at():
    """Transcendentals (sigmoid, softplus, tanh) of two libraries: 1e-6."""
    r = np.random.default_rng(1)
    raw = (2 * r.normal(size=(3, 50, 13))).astype(np.float32)
    pos = r.uniform(-0.5, 0.5, (3, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        activate_gaussians_at(t(pos), t(raw)).numpy(),
        np.asarray(jactivate_at(jnp.asarray(pos), jnp.asarray(raw))),
        atol=1e-6, rtol=1e-6)


def test_cameras():
    """Poses are numpy in both packages (exact); the camera matrices go
    through a 4x4 inverse in each framework (2e-6 of O(1) entries)."""
    np.testing.assert_array_equal(cameras.uni_mesh_path(8),
                                  jcameras.uni_mesh_path(8))
    poses = cameras.generate_input_camera(1.8, [(20, 45), (-30, 200),
                                                (60, 10)])
    np.testing.assert_array_equal(
        poses, jcameras.generate_input_camera(1.8, [(20, 45), (-30, 200),
                                                     (60, 10)]))
    got = cameras.pose_to_gs_camera(poses)
    ref = jcameras.pose_to_gs_camera(jnp.asarray(poses))
    for k in ("cam_view", "cam_view_proj", "cam_pos", "tanfov"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid", "torus", None])
def test_make_object(kind):
    """Same numpy draws: bit-equal."""
    np.testing.assert_array_equal(
        make_object(3, n=300, kind=kind).numpy(),
        np.asarray(jmake_object(3, n=300, kind=kind)))


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("shape", [(512, 518), (64, 56), (56, 70),
                                   (37, 20)])
def test_resize_matches_jax_image_resize(method, shape):
    """Keys a=-0.5 / triangle kernels, half-pixel centres, renormalised
    borders and antialiased downsampling: the same separable weights, so
    only the summation order differs (1e-5 of O(1) values)."""
    n_in, n_out = shape
    r = np.random.default_rng(2)
    x = r.uniform(size=(2, 3, n_in, n_in)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, n_out, n_out), method)
    got = resize(t(x), (n_out, n_out), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_resize_is_not_torch_bicubic():
    """The trap the port designs against: torch's bicubic (a = -0.75,
    clamped borders) is a different function."""
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    ours = resize(x, (56, 56), "cubic", antialias=False)
    theirs = torch.nn.functional.interpolate(x, (56, 56), mode="bicubic",
                                             align_corners=False)
    assert float((ours - theirs).abs().max()) > 1e-3


def test_ply_writers_match(tmp_path):
    r = np.random.default_rng(3)
    g = np.concatenate([r.uniform(-0.4, 0.4, (40, 3)),
                        r.uniform(0.05, 0.95, (40, 1)),
                        r.uniform(1e-3, 1e-2, (40, 2)),
                        r.normal(size=(40, 4)),
                        r.uniform(0, 1, (40, 3))], 1).astype(np.float32)
    for name, ours, theirs, arr in (
            ("g.ply", ply_io.save_2dgs_ply, jply.save_2dgs_ply, g),
            ("p.ply", ply_io.save_pointcloud_ply, jply.save_pointcloud_ply,
             g[:, :3])):
        ours(os.path.join(tmp_path, "a" + name), arr)
        theirs(os.path.join(tmp_path, "b" + name), arr)
        with open(os.path.join(tmp_path, "a" + name), "rb") as fa, \
                open(os.path.join(tmp_path, "b" + name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _glb_chunks(path):
    with open(path, "rb") as f:
        data = f.read()
    jlen = struct.unpack("<I", data[12:16])[0]
    js = data[20:20 + jlen]
    return js, data[20 + jlen + 8:]


def test_glb_writer_matches(tmp_path):
    """Same glTF document and binary buffer; only the generator string
    names the other package."""
    xyz = np.random.default_rng(4).uniform(-0.4, 0.4, (30, 3)).astype(
        np.float32)
    ply_io.save_pointcloud_glb(os.path.join(tmp_path, "a.glb"), xyz)
    jply.save_pointcloud_glb(os.path.join(tmp_path, "b.glb"), xyz)
    ja, ba = _glb_chunks(os.path.join(tmp_path, "a.glb"))
    jb, bb = _glb_chunks(os.path.join(tmp_path, "b.glb"))
    assert ba == bb
    assert ja.replace(b"gaussiananything_tpu_torch",
                      b"gaussiananything_tpu").rstrip() == jb.rstrip()


def test_save_png_round_trip(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (7, 5, 3), np.uint8)
    path = os.path.join(tmp_path, "x.png")
    save_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (5, 7)
    idat_len = struct.unpack(">I", data[33:37])[0]
    rows = np.frombuffer(zlib.decompress(data[41:41 + idat_len]), np.uint8)
    rows = rows.reshape(7, 1 + 5 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(7, 5, 3), img)
