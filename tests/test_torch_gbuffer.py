"""The port's g-buffer dataset against the JAX package's on the CPU: the
files `export_synthetic_dataset` writes, the batches `MultiViewDataset`
draws from the same files and seed (view for view, point for point), the
frame-0 canonicalisation, shards, the prefetching iterator, and the
per-view `tanfov` the port keeps where the JAX package keeps one."""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.data import gbuffer as jgb
from gaussiananything_tpu.data import postprocess as jpp
from gaussiananything_tpu_torch.data import gbuffer as gb
from gaussiananything_tpu_torch.data import postprocess as pp
from gaussiananything_tpu_torch.render import cameras

torch.set_num_threads(2)

EXPORT = dict(n_instances=3, n_views=6, res=32, n_splats=256, seed=0)
KW = dict(n_views_in=2, n_views_sup=2, n_points=64, seed=3)
# keys whose values the two packages compute (the others are loaded)
COMPUTED = ("images_in", "pcd", "cam_view", "cam_view_proj", "cam_pos")
LOADED = ("images_sup", "alpha_sup", "depth_sup")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The same procedural dataset written by each package."""
    root = tmp_path_factory.mktemp("gbuffer")
    jgb.export_synthetic_dataset(str(root / "jax"), **EXPORT)
    gb.export_synthetic_dataset(str(root / "port"), **EXPORT)
    return str(root / "jax"), str(root / "port")


def test_export_matches_jax(exported):
    """Poses and point clouds are the same draws, bit for bit; the maps
    are renders of the same scenes by two rasterizers (atol 2e-5 / rtol
    1e-4 apart, test_torch_rasterize.py), so after uint8 and float16
    rounding a value may sit one step apart: rgb and alpha by at most 1 in
    at most 1% of the values, normal and depth within 2e-3."""
    jdir, pdir = exported
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) == \
        [f"{i:05d}.npz" for i in range(EXPORT["n_instances"])]
    for n in names:
        with np.load(os.path.join(jdir, n)) as j, \
                np.load(os.path.join(pdir, n)) as p:
            assert sorted(j.files) == sorted(p.files)
            for k in j.files:
                assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape
            for k in ("pose", "pcd"):
                np.testing.assert_array_equal(p[k], j[k])
            for k in ("rgb", "alpha"):
                d = np.abs(p[k].astype(int) - j[k].astype(int))
                assert d.max() <= 1 and (d > 0).mean() <= 0.01, k
            for k in ("normal", "depth"):
                np.testing.assert_allclose(p[k].astype(np.float32),
                                           j[k].astype(np.float32),
                                           atol=2e-3, err_msg=k)


def _assert_batches_equal(pb, jb, atol=1e-6):
    """Loaded maps bit-equal; computed tensors within `atol` (1e-6 in
    float32: Plücker rays, backprojection and camera inverses in other
    sum orders)."""
    for k in LOADED:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
    for k in COMPUTED:
        np.testing.assert_allclose(pb[k].numpy(), np.asarray(jb[k]),
                                   rtol=1e-6, atol=atol, err_msg=k)
    # the port keeps each supervision view's tanfov, JAX one scalar; the
    # dataset's views share one field of view
    np.testing.assert_allclose(pb["tanfov"].numpy(),
                               np.full(pb["cam_view"].shape[:2],
                                       float(jb["tanfov"])), rtol=1e-6)
    assert pb["caption"] == jb["caption"]


@pytest.mark.parametrize("resolution", [None, 24])
def test_batches_match_jax(exported, resolution):
    """Two batches in turn from the JAX-written files, the same seed:
    the same instances, views and points; 24 exercises the nearest-index
    resize."""
    jdir, _ = exported
    jds = jgb.MultiViewDataset(jdir, resolution=resolution, **KW)
    pds = gb.MultiViewDataset(jdir, resolution=resolution, **KW)
    for _ in range(2):
        pb, jb = pds.batch(2), jds.batch(2)
        assert pb["images_in"].shape == (2, 2, 15) + (resolution or 32,) * 2
        _assert_batches_equal(pb, jb)


def test_canonicalized_batches_match_jax(exported):
    """With `canonicalize` the rebased poses and point cloud within 2e-4
    (tests/test_data.py's tolerance), and the rebased cameras see the
    point cloud where the original cameras saw the original one."""
    jdir, _ = exported
    pb = gb.MultiViewDataset(jdir, canonicalize=True, **KW).batch(2)
    jb = jgb.MultiViewDataset(jdir, canonicalize=True, **KW).batch(2)
    for k in COMPUTED:
        np.testing.assert_allclose(pb[k].numpy(), np.asarray(jb[k]),
                                   atol=2e-4, err_msg=k)
    plain = gb.MultiViewDataset(jdir, **KW).batch(2)
    assert not torch.allclose(plain["pcd"], pb["pcd"])

    def project(b):
        h = torch.cat([b["pcd"], torch.ones_like(b["pcd"][..., :1])], -1)
        clip = torch.einsum("bnj,bjk->bnk", h, b["cam_view_proj"][:, 0])
        return clip[..., :2] / torch.clamp(clip[..., 3:4], min=1e-6)

    torch.testing.assert_close(project(pb), project(plain), atol=2e-4,
                               rtol=0)


def test_canonicalize_functions_match_jax():
    """`canonicalize_poses` and `canonicalize_pts` on random poses and
    points within 2e-4 of JAX's (`tests/test_data.py:66`)."""
    r = np.random.default_rng(0)
    poses = cameras.generate_input_camera(
        1.8, [(r.uniform(-30, 60), r.uniform(0, 360)) for _ in range(5)])
    pcd = r.uniform(-0.5, 0.5, (3, 40, 3)).astype(np.float32)
    for idx in (0, 3):
        np.testing.assert_allclose(
            pp.canonicalize_poses(torch.from_numpy(poses), idx).numpy(),
            np.asarray(jpp.canonicalize_poses(jnp.asarray(poses), idx)),
            atol=2e-4)
        np.testing.assert_allclose(
            pp.canonicalize_pts(torch.from_numpy(poses),
                                torch.from_numpy(pcd), idx).numpy(),
            np.asarray(jpp.canonicalize_pts(jnp.asarray(poses),
                                            jnp.asarray(pcd), idx)),
            atol=2e-4)
    # the canonical view lands at identity rotation on -z at its radius
    c = pp.canonicalize_poses(torch.from_numpy(poses))[0, :16].reshape(4, 4)
    torch.testing.assert_close(c[:3, :3], torch.eye(3), atol=1e-5, rtol=0)
    assert abs(float(c[2, 3]) + 1.8) < 1e-5


def test_shards_match_jax(exported):
    """Shard (1, 2) takes every second file from the second, and draws
    from seed + 1, as JAX's."""
    jdir, _ = exported
    pds = gb.MultiViewDataset(jdir, shard=(1, 2), **KW)
    jds = jgb.MultiViewDataset(jdir, shard=(1, 2), **KW)
    assert pds.files == jds.files and len(pds.files) == 1
    other = gb.MultiViewDataset(jdir, shard=(0, 2), **KW)
    assert set(other.files).isdisjoint(pds.files)
    _assert_batches_equal(pds.batch(2), jds.batch(2))
    with pytest.raises(ValueError, match="no instances"):
        gb.MultiViewDataset(jdir, shard=(5, 6), **KW)


def test_iterator_yields_the_batch_sequence(exported, tmp_path):
    """The prefetching iterator gives what `batch` gives in turn, and an
    error in its thread reaches the consumer."""
    _, pdir = exported
    it = gb.MultiViewDataset(pdir, **KW).iterator(2, prefetch=2)
    seq = gb.MultiViewDataset(pdir, **KW)
    for _ in range(3):
        a, b = next(it), seq.batch(2)
        for k in COMPUTED + LOADED + ("tanfov",):
            assert torch.equal(a[k], b[k]), k
    it.close()
    (tmp_path / "00000.npz").write_bytes(b"not an npz")
    bad = gb.MultiViewDataset(str(tmp_path), **KW).iterator(1)
    with pytest.raises(Exception):
        next(bad)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_iterator_with_decoding_workers_yields_the_batch_sequence(
        exported, batch_size):
    """With several threads decoding ahead, the iterator still gives what
    `batch` gives in turn (the draws are made in one thread, in order), and
    an error in a decoding thread reaches the consumer."""
    _, pdir = exported
    it = gb.MultiViewDataset(pdir, **KW).iterator(batch_size, prefetch=2,
                                                  workers=3)
    seq = gb.MultiViewDataset(pdir, **KW)
    for _ in range(5):
        a, b = next(it), seq.batch(batch_size)
        assert a["caption"] == b["caption"]
        for k in COMPUTED + LOADED + ("tanfov",):
            assert torch.equal(a[k], b[k]), k
    it.close()
    bad = gb.MultiViewDataset(pdir, **KW)
    plan, load, plans = bad._plan, bad._load, []

    def planned():
        plans.append(plan())
        return plans[-1]

    def failing(p):
        if len(plans) > 2 and p is plans[2]:
            raise OSError("unreadable map")
        return load(p)
    bad._plan, bad._load = planned, failing
    it = bad.iterator(1, workers=2)
    next(it), next(it)
    with pytest.raises(OSError, match="unreadable map"):
        next(it)


def test_member_reader_equals_np_load(exported):
    """The one-call member reader gives `np.load`'s arrays, bit for bit,
    dtype and shape included."""
    _, pdir = exported
    names = ("rgb", "normal", "depth", "alpha", "pose", "pcd")
    for path in sorted(os.listdir(pdir)):
        if not path.endswith(".npz"):
            continue
        got = gb._read_members(os.path.join(pdir, path), names)
        with np.load(os.path.join(pdir, path)) as want:
            for n in names:
                assert got[n].dtype == want[n].dtype, n
                np.testing.assert_array_equal(got[n], want[n])


def test_per_view_tanfov(tmp_path):
    """An instance whose views differ in field of view: each supervision
    view keeps its own tanfov, tan(fov / 2) of the pose it was drawn with
    (the JAX package keeps the first view's for all), and the training
    loss takes it."""
    fovs = [20.0, 30.0, 40.0, 50.0]
    poses = np.concatenate([cameras.generate_input_camera(
        1.8, [(10.0, 90.0 * i)], fov_deg=f) for i, f in enumerate(fovs)])
    V, res = len(fovs), 16
    gb.pack_instance(str(tmp_path / "a.npz"),
                     rgb=np.full((V, res, res, 3), 128, np.uint8),
                     normal=np.zeros((V, res, res, 3)),
                     depth=np.full((V, res, res), 1.5),
                     alpha=np.ones((V, res, res)), pose=poses,
                     pcd=np.zeros((10, 3)))
    ds = gb.MultiViewDataset(str(tmp_path), n_views_in=1, n_views_sup=3,
                             n_points=8, seed=0)
    b = ds.batch(2)
    # the draws `_sample` makes: the instance, the views, the points
    rng, vsup = np.random.default_rng(0), []
    for _ in range(2):
        rng.integers(1)
        vsup.append(rng.choice(V, 4, replace=False)[1:])
        rng.choice(10, 8, replace=False)
    want = np.tan(np.radians(fovs) / 2)[np.stack(vsup)]
    np.testing.assert_allclose(b["tanfov"].numpy(), want, rtol=1e-6)
    assert len(np.unique(np.round(want, 6))) > 1
    jb = jgb.MultiViewDataset(str(tmp_path), n_views_in=1, n_views_sup=3,
                              n_points=8, seed=0).batch(2)
    np.testing.assert_allclose(b["cam_view_proj"].numpy(),
                               np.asarray(jb["cam_view_proj"]), atol=1e-6)
    assert np.ndim(jb["tanfov"]) == 0
    from gaussiananything_tpu_torch.train.losses import depth_to_normal
    n = depth_to_normal(torch.full((2, 3, 1, res, res), 1.5),
                        b["cam_view"], b["tanfov"])
    assert n.shape == (2, 3, 3, res, res) and torch.isfinite(n).all()


def test_pack_load_and_caption(tmp_path):
    r = np.random.default_rng(0)
    inst = dict(rgb=r.integers(0, 256, (2, 4, 4, 3)),
                normal=r.normal(size=(2, 4, 4, 3)),
                depth=r.uniform(1, 2, (2, 4, 4)),
                alpha=r.uniform(0, 1, (2, 4, 4)),
                pose=r.normal(size=(2, 25)), pcd=r.normal(size=(5, 3)))
    gb.pack_instance(str(tmp_path / "x.npz"), **inst)
    jgb.pack_instance(str(tmp_path / "y.npz"), **inst)
    a, b = gb.load_instance(str(tmp_path / "x.npz")), \
        jgb.load_instance(str(tmp_path / "y.npz"))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    assert gb.MultiViewDataset.caption_for(str(tmp_path / "x.npz")) == ""
    (tmp_path / "x.caption.txt").write_text(" a chair \n")
    assert gb.MultiViewDataset.caption_for(str(tmp_path / "x.npz")) == \
        "a chair"
