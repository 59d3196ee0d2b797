"""The TSDF mesh path of the port against the JAX package: `integrate_tsdf`
(plain PyTorch) against JAX's jitted integrate and against the native
OpenMP integrate the port builds from `native/surface_nets.cc`; the NumPy
`surface_nets` against JAX's and the native extractor against it; the
whole `export_mesh_from_gaussians` on a surfel sphere.

Tolerances: the integrates 2e-5 (`tests/test_native.py:45-78`), the
surface nets 1e-4 (`tests/test_native.py:27`), the sphere mesh's mean
radius within 0.02 of JAX's (`tests/test_tsdf.py:19`), its median within
0.06 of the sphere's (`tests/test_tsdf.py:34`) and its vertex and face
counts equal to JAX's.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu import native_bindings as jnative
from gaussiananything_tpu.data.synthetic import make_object as jmake_object
from gaussiananything_tpu.render import tsdf as jtsdf
from gaussiananything_tpu_torch import native_bindings
from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.render import tsdf
from gaussiananything_tpu_torch.render.ply_io import read_ply

torch.set_num_threads(2)
BOUND = 0.495


def _views(seed=0, V=3, H=17, W=19):
    rng = np.random.default_rng(seed)
    depth = (1.5 + 0.3 * rng.random((V, 1, H, W))).astype(np.float32)
    rgb = rng.random((V, 3, H, W)).astype(np.float32)
    alpha = (rng.random((V, 1, H, W)) > 0.2).astype(np.float32)
    cv = np.stack([np.eye(4, dtype=np.float32) for _ in range(V)])
    cv[:, 3, 2] = 2.0 + 0.2 * np.arange(V)
    cv[1:, 3, 0] = 0.1
    return depth, rgb, alpha, cv, 0.6


def _jax_integrate(depth, rgb, alpha, cv, tanfov, D):
    t, c = jtsdf.integrate_tsdf(jnp.asarray(depth), jnp.asarray(rgb),
                                jnp.asarray(alpha), jnp.asarray(cv),
                                jnp.asarray(tanfov), resolution=D)
    return np.asarray(t), np.asarray(c)


@pytest.mark.parametrize("D", [16, 48])
def test_integrate_against_jax_and_native(D):
    depth, rgb, alpha, cv, tanfov = _views()
    ref_t, ref_c = _jax_integrate(depth, rgb, alpha, cv, tanfov, D)
    got_t, got_c = tsdf.integrate_tsdf(
        torch.from_numpy(depth), torch.from_numpy(rgb),
        torch.from_numpy(alpha), torch.from_numpy(cv), tanfov, resolution=D)
    assert got_t.shape == (D, D, D) and got_c.shape == (3, D, D, D)
    assert (got_t.numpy() < 1).mean() > 0.01     # the views see voxels
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=2e-5)
    np.testing.assert_allclose(got_c.numpy(), ref_c, atol=2e-5)
    nat_t, nat_c = native_bindings.tsdf_integrate(depth, rgb, alpha, cv,
                                                  tanfov, resolution=D)
    np.testing.assert_allclose(nat_t, got_t.numpy(), atol=2e-5)
    np.testing.assert_allclose(nat_c, np.moveaxis(got_c.numpy(), 0, -1),
                               atol=2e-5)


def _sphere_sdf(D=32, r=0.3):
    lin = (np.arange(D) + 0.5) / D * 2 * BOUND - BOUND
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - r).astype(np.float32)
    col = np.random.default_rng(0).uniform(size=(D, D, D, 3)) \
        .astype(np.float32)
    return sdf, col


def _sorted_rows(v):
    return np.array(sorted(map(tuple, np.round(v, 5))))


def test_surface_nets_python_native_jax():
    sdf, col = _sphere_sdf()
    v_py, f_py, c_py = tsdf.surface_nets(sdf, col, BOUND)
    v_j, f_j, c_j = jtsdf.surface_nets(sdf, col, BOUND)
    np.testing.assert_allclose(v_py, v_j, atol=1e-4)
    assert np.array_equal(f_py, f_j)
    np.testing.assert_allclose(c_py, c_j, atol=1e-4)
    v_n, f_n, c_n = native_bindings.surface_nets(sdf, col, BOUND)
    assert len(v_n) == len(v_py) and len(f_n) == len(f_py)
    np.testing.assert_allclose(_sorted_rows(v_n), _sorted_rows(v_py),
                               atol=1e-4)
    assert c_n.shape == (len(v_n), 3) and f_n.max() < len(v_n)
    assert abs(np.linalg.norm(v_n, axis=1).mean() - 0.3) < 0.02
    empty = tsdf.surface_nets(np.ones((8, 8, 8), np.float32))
    assert empty[0].shape == (0, 3) and empty[2] is None


def test_native_build_is_the_ports_own():
    """Built from the repository's source into the port's git-ignored
    directory, not into native/."""
    path = native_bindings._build()
    assert os.path.dirname(path) == native_bindings.BUILD_DIR
    assert native_bindings.SOURCE.endswith(
        os.path.join("native", "surface_nets.cc"))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback: the compiler's message is raised."""
    bad = tmp_path / "bad.cc"
    bad.write_text("int x = ;\n")
    monkeypatch.setattr(native_bindings, "SOURCE", str(bad))
    monkeypatch.setattr(native_bindings, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="expected primary-expression"):
        native_bindings._build()
    assert os.listdir(tmp_path / "b") == []


def test_export_mesh_sphere(tmp_path, monkeypatch):
    """A 1024-surfel sphere of radius 0.35, 4 azimuths at 5 elevations at
    96², D 48. JAX
    integrates through its jitted function here (its export would take
    the native integrate on f16-rounded renders otherwise)."""
    monkeypatch.setattr(jnative, "have_tsdf_integrate", lambda: False)
    kw = dict(resolution=48, n_views=4, render_size=96)
    jv, jf = jtsdf.export_mesh_from_gaussians(
        str(tmp_path / "jax.obj"), jmake_object(0, n=1024, kind="sphere"),
        **kw)
    timings = {}
    path = str(tmp_path / "mesh.glb")
    v, f = tsdf.export_mesh_from_gaussians(
        path, make_object(0, n=1024, kind="sphere"), timings=timings, **kw)
    assert len(v) > 50 and f.max() < len(v)
    assert len(v) == len(jv) and len(f) == len(jf)
    rad, jrad = np.linalg.norm(v, axis=1), np.linalg.norm(jv, axis=1)
    assert abs(float(rad.mean()) - float(jrad.mean())) < 0.02
    assert abs(float(np.median(rad)) - 0.35) < 0.06    # test_tsdf.py:34
    assert os.path.getsize(path) > 1000
    assert set(timings) == {"mesh render", "mesh integrate",
                            "mesh surface nets"}
    obj = str(tmp_path / "mesh.obj")
    tsdf.write_mesh(obj, v, f)
    with open(obj) as fh:
        lines = fh.read().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(v)


def test_read_ply_ascii(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                 "property float x\nproperty float y\nend_header\n"
                 "1 2\n3 4\n")
    got = read_ply(str(p))
    assert np.array_equal(got["x"], [1, 3]) and np.array_equal(got["y"],
                                                                [2, 4])
