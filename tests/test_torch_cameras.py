"""The port's camera, quaternion and gaussian helpers against the JAX
package's (`render/cameras.py`, `utils/quaternions.py`,
`ops/gaussians.py`), mirroring `tests/test_cameras.py`: the same numpy
poses and draws through both. Poses are numpy in both packages (exact);
camera matrices go through a 4x4 inverse in each framework (2e-6 of O(1)
entries, as `tests/test_torch_leaf.py`); quaternions 1e-6."""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.ops import gaussians as jgaussians
from gaussiananything_tpu.render import cameras as jcameras
from gaussiananything_tpu.utils import quaternions as jquat
from gaussiananything_tpu_torch.ops import gaussians
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.utils import quaternions as quat

MATRIX_TOL = dict(atol=2e-6, rtol=1e-6)
QUAT_TOL = dict(atol=1e-6, rtol=1e-6)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **(tol or MATRIX_TOL))


def test_world2view_roundtrip_and_jax():
    pose = cameras.generate_input_camera(1.8, [(20, 65)])[0]
    c2w = pose[:16].reshape(4, 4)
    cam_view = cameras.world2view(torch.from_numpy(c2w))
    origin = torch.tensor([*c2w[:3, 3], 1.0]) @ cam_view
    np.testing.assert_allclose(origin[:3].numpy(), 0.0, atol=1e-5)
    _close(cam_view, jcameras.world2view(jnp.asarray(c2w)))


def test_camera_looks_at_origin():
    pose = cameras.generate_input_camera(1.8, [(30, 120)])[0]
    cam = cameras.pose_to_gs_camera(pose)
    h = torch.tensor([0.0, 0.0, 0.0, 1.0]) @ cam["cam_view_proj"]
    np.testing.assert_allclose((h[:2] / h[3]).numpy(), 0.0, atol=1e-5)
    view = torch.tensor([0.0, 0.0, 0.0, 1.0]) @ cam["cam_view"]
    assert float(view[2]) > 0
    np.testing.assert_allclose(float(view[2]), 1.8, atol=1e-5)
    np.testing.assert_allclose(cam["cam_pos"].numpy(),
                               pose[:16].reshape(4, 4)[:3, 3], atol=1e-6)


def test_projection_depth_range():
    pose = cameras.generate_input_camera(1.8, [(0, 0)])[0]
    cam = cameras.pose_to_gs_camera(pose)
    cam_pos = cam["cam_pos"].numpy()
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    for dist, expect in [(cameras.ZNEAR, 0.0), (cameras.ZFAR, 1.0)]:
        p = cam_pos + fwd * dist
        h = torch.tensor([*p, 1.0], dtype=torch.float32) \
            @ cam["cam_view_proj"]
        np.testing.assert_allclose(float(h[2] / h[3]), expect, atol=1e-4)


@pytest.mark.parametrize("fov_y", [None, math.radians(40.0)])
def test_projection_matrix_equals_jax(fov_y):
    got = cameras.projection_matrix(fov_x=math.radians(30.0), fov_y=fov_y)
    ref = jcameras.projection_matrix(fov_x=math.radians(30.0), fov_y=fov_y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fov_focal_roundtrip_and_jax():
    for fov in (math.radians(30.0), 0.7, 1.2):
        assert cameras.fov2focal(fov, 512) == jcameras.fov2focal(fov, 512)
        back = cameras.focal2fov(torch.tensor(cameras.fov2focal(fov, 1.0)))
        np.testing.assert_allclose(float(back), fov, rtol=1e-6)


def test_sample_uniform_cameras_on_sphere_equals_jax():
    got = cameras.sample_uniform_cameras_on_sphere(
        np.random.default_rng(3), 6, radius=2.0)
    ref = jcameras.sample_uniform_cameras_on_sphere(
        np.random.default_rng(3), 6, radius=2.0)
    assert got.shape == (6, 25)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(
        np.linalg.norm(got[:, :16].reshape(6, 4, 4)[:, :3, 3], axis=-1),
        2.0, rtol=1e-6)


def test_pose_to_gs_camera_returns_jax_keys():
    """`source_cv2wT_quat` and `orig_c2w` beside the render matrices."""
    poses = cameras.sample_uniform_cameras_on_sphere(
        np.random.default_rng(4), 5)
    got = cameras.pose_to_gs_camera(poses)
    ref = jcameras.pose_to_gs_camera(jnp.asarray(poses))
    assert set(got) == set(ref)
    for k in ("cam_view", "cam_view_proj", "cam_pos", "tanfov"):
        _close(got[k], ref[k])
    np.testing.assert_array_equal(got["orig_c2w"].numpy(),
                                  np.asarray(ref["orig_c2w"]))
    _close(got["source_cv2wT_quat"], ref["source_cv2wT_quat"], **QUAT_TOL)


def test_plucker_rays_shape_and_norm():
    pose = cameras.generate_input_camera(1.8, [(10, 30)])[0]
    c2w = torch.from_numpy(pose[:16].reshape(4, 4))
    K = torch.from_numpy(pose[16:].reshape(3, 3))
    pl = cameras.plucker_rays(c2w, K, 32, 32)
    assert pl.shape == (6, 32, 32)
    d = pl[3:].numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-5)
    assert np.dot(d[:, 16, 16], c2w[:3, 2].numpy()) > 0.99


def test_uni_mesh_path_count():
    assert cameras.uni_mesh_path(10).shape == (50, 25)


def _unit_quats(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[:, :1] < 0, -1, 1)


def test_rotmat_quat_roundtrip_and_jax():
    q = _unit_quats(0, 64)
    R = quat.quat_to_rotmat(torch.from_numpy(q))
    got = quat.rotmat_to_quat(R)
    np.testing.assert_allclose(got.numpy(), q, atol=1e-4)
    _close(got, jquat.rotmat_to_quat(jnp.asarray(R.numpy())), **QUAT_TOL)


def test_rotmat_to_quat_ties_take_the_first_candidate():
    """A 120° turn about (1, 1, 1): all four candidates tie, and both
    packages keep the w one (`jnp.argmax` takes the lowest index)."""
    m = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    got = quat.rotmat_to_quat(torch.from_numpy(m))
    ref = jquat.rotmat_to_quat(jnp.asarray(m))
    _close(got, ref, **QUAT_TOL)
    np.testing.assert_allclose(got.numpy(), [0.5, 0.5, 0.5, 0.5], atol=1e-6)


def test_quat_mul_equals_jax():
    a, b = _unit_quats(1, 16), _unit_quats(2, 16)
    got = quat.quat_mul(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, jquat.quat_mul(jnp.asarray(a), jnp.asarray(b)), **QUAT_TOL)
    # the product rotates as the rotations compose
    Rab = quat.quat_to_rotmat(got)
    Ra = quat.quat_to_rotmat(torch.from_numpy(a))
    Rb = quat.quat_to_rotmat(torch.from_numpy(b))
    np.testing.assert_allclose(Rab.numpy(), (Ra @ Rb).numpy(), atol=1e-5)


def test_inverse_sigmoid_and_offset_gain_equal_jax():
    assert gaussians.POS_OFFSET_GAIN == jgaussians.POS_OFFSET_GAIN
    x = np.array([0.0, 1e-7, 0.1, 0.5, 0.9, 1.0 - 1e-7, 1.0], np.float32)
    got = gaussians.inverse_sigmoid(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jgaussians.inverse_sigmoid(
                                   jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.sigmoid(got[2:5]).numpy(), x[2:5],
                               rtol=1e-6)
