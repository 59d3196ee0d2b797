"""The port's raw-dataset ingestion (`data/objaverse_raw.py`, its own copy
of the JAX package's numpy module) against the JAX module: the cases of
`tests/test_objaverse_raw.py` with both modules on the same inputs, whose
outputs are byte-equal (EXR files, decoded channels, chunks, instances),
and a directory converted by the port read back by the port's
`MultiViewDataset` as the JAX dataset reads it (1e-6, the g-buffer
tests' tolerance)."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussiananything_tpu.data import gbuffer as jgbuffer
from gaussiananything_tpu.data import objaverse_raw as jraw
from gaussiananything_tpu_torch.data import gbuffer
from gaussiananything_tpu_torch.data import objaverse_raw as raw
from gaussiananything_tpu_torch.render import cameras

torch.set_num_threads(2)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def _channels(h, w, seed):
    rng = np.random.default_rng(seed)
    return {"R": rng.standard_normal((h, w)).astype(np.float32),
            "G": rng.standard_normal((h, w)).astype(np.float32),
            "B": rng.standard_normal((h, w)).astype(np.float32),
            "A": rng.random((h, w)).astype(np.float32) * 3}


@pytest.mark.parametrize("comp,ptype,h,w", [
    (raw._COMP_ZIP, raw._PT_HALF, 37, 23),
    (raw._COMP_ZIPS, raw._PT_HALF, 37, 23),
    (raw._COMP_NONE, raw._PT_FLOAT, 37, 23),
    (raw._COMP_ZIP, raw._PT_FLOAT, 16, 16)])
def test_exr_files_and_decode_equal(tmp_path, comp, ptype, h, w):
    chans = _channels(h, w, comp * 10 + ptype)
    paths = [str(tmp_path / f"{n}.exr") for n in ("port", "jax")]
    raw.write_exr(paths[0], chans, pixel_type=ptype, compression=comp)
    jraw.write_exr(paths[1], chans, pixel_type=ptype, compression=comp)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    _equal(raw.read_exr(paths[1]), jraw.read_exr(paths[1]))
    with open(paths[1], "rb") as f:
        _equal(raw.read_exr(f.read()), jraw.read_exr(paths[1]))


def test_exr_refusals(tmp_path):
    path = str(tmp_path / "piz.exr")
    raw.write_exr(path, {"R": np.zeros((4, 4), np.float32)})
    data = bytearray(open(path, "rb").read())
    i = data.index(b"compression\x00compression\x00")
    data[i + len(b"compression\x00compression\x00") + 4] = raw._COMP_PIZ
    for mod in (raw, jraw):
        with pytest.raises(ValueError, match="unsupported"):
            mod.read_exr(bytes(data))
        with pytest.raises(ValueError, match="not an EXR"):
            mod.read_exr(b"\x00" * 16)


@pytest.mark.parametrize("shape,size", [((16, 16), None), ((8, 8), (4, 4)),
                                        ((16, 8), (8, 4))])
def test_read_dnormal_equal(tmp_path, shape, size):
    rng = np.random.default_rng(0)
    depth = np.full(shape, 1.8, np.float32)
    depth[0, :] = 0.5                      # nearer than the cull plane
    path = str(tmp_path / "dn.exr")
    raw.write_exr(path, {"R": rng.standard_normal(shape).astype(np.float32),
                         "G": rng.standard_normal(shape).astype(np.float32),
                         "B": rng.standard_normal(shape).astype(np.float32),
                         "A": depth}, pixel_type=raw._PT_FLOAT)
    kw = dict(h=size[0], w=size[1]) if size else {}
    got = raw.read_dnormal(path, np.array([2.0, 0.0, 0.0]), **kw)
    _equal(got, jraw.read_dnormal(path, np.array([2.0, 0.0, 0.0]), **kw))
    if size is None:
        assert (got[0][0] == 0).all()


def test_decode_helpers_equal(tmp_path):
    n = np.random.default_rng(1).normal(size=(3, 5, 3))
    _equal(raw.unity2blender_fix(n), jraw.unity2blender_fix(n))
    for h, w in ((512, 512), (320, 256)):
        for norm in (False, True):
            _equal(raw.get_intri(h, w, norm), jraw.get_intri(h, w, norm))
    path = str(tmp_path / "pose.json")
    with open(path, "w") as f:
        json.dump({"x": [0.6, 0, 0.8], "y": [0, 1, 0], "z": [-0.8, 0, 0.6],
                   "origin": [0.1, 0.2, 1.3]}, f)
    c2w = raw.read_camera_matrix_single(path)
    _equal(c2w, jraw.read_camera_matrix_single(path))
    _equal(raw.pose_25d(c2w, 512, 512), jraw.pose_25d(c2w, 512, 512))
    m = (np.random.default_rng(2).random((9, 7)) > 0.3).astype(np.float32)
    _equal(raw._erode_cross(m), jraw._erode_cross(m))
    img = np.arange(5 * 7 * 3).reshape(5, 7, 3)
    _equal(raw._resize_nearest(img, 3, 4), jraw._resize_nearest(img, 3, 4))


def _chunk(d, V=4, h=16, w=16, seed=0, quantised=False):
    """A raw chunk directory: the strips of `tests/test_objaverse_raw.py`
    (PNG rgb/alpha + depth.npz), or the quantised layout (depth_alpha.jpg +
    d_near_far.npy)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    rgb = (rng.random((V, h, w, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb.transpose(1, 0, 2, 3).reshape(h, V * w, 3)).save(
        os.path.join(d, "raw_img.png"))
    depth = rng.random((V, h, w)).astype(np.float32) + 1.0
    if quantised:
        alpha = np.full((V, h, w), 255, np.uint8)
        alpha[:, :2] = 0
        q = (rng.random((V, h, w)) * 255).astype(np.uint8)
        da = np.concatenate([q, alpha], axis=1)      # (V, 2h, w)
        Image.fromarray(da.transpose(1, 0, 2).reshape(2 * h, V * w)).save(
            os.path.join(d, "depth_alpha.jpg"), quality=100)
        np.save(os.path.join(d, "d_near_far.npy"),
                np.stack([np.full(V, 0.4), np.full(V, 1.2)]).astype(
                    np.float32))
    else:
        alpha = np.full((V, h, w), 255, np.uint8)
        Image.fromarray(alpha.transpose(1, 0, 2).reshape(h, V * w)).save(
            os.path.join(d, "alpha.png"))
        np.savez(os.path.join(d, "depth.npz"), depth=depth)
    normal01 = rng.random((V, h, w, 3)).astype(np.float32)
    Image.fromarray((normal01.transpose(1, 0, 2, 3).reshape(h, V * w, 3)
                     * 255).astype(np.uint8)).save(
        os.path.join(d, "normal.png"))
    poses = cameras.generate_input_camera(
        1.8, [(20, 45 + 90 * i) for i in range(V)])
    np.save(os.path.join(d, "c.npy"), np.asarray(poses, np.float32))
    np.save(os.path.join(d, "bbox.npy"),
            np.array([[-0.45] * 3, [0.45] * 3], np.float32))
    for name, txt in (("caption.txt", f"a test object {seed}"),
                      ("ins.txt", f"fixture/{seed}")):
        with open(os.path.join(d, name), "w") as f:
            f.write(txt)


@pytest.mark.parametrize("quantised", [False, True])
def test_chunk_and_instance_equal(tmp_path, quantised):
    d = str(tmp_path / "c")
    _chunk(d, quantised=quantised)
    got = raw.read_chunk(d, chunk_size=4, img_ext="png")
    _equal(got, jraw.read_chunk(d, chunk_size=4, img_ext="png"))
    assert got[0].shape == (4, 16, 16, 3) and got[1].dtype == np.float32
    _equal(raw.raw_chunk_to_instance(d, 4, "png", n_pcd=300, seed=3),
           jraw.raw_chunk_to_instance(d, 4, "png", n_pcd=300, seed=3))


def test_converted_directory_reads_back(tmp_path):
    """`convert_raw_dir` over two chunks (one nested) writes the instances
    and caption sidecars the JAX module writes (arrays equal: the npz
    archives differ only in their zip timestamps); the port's
    `MultiViewDataset` reads the directory into the batch the JAX dataset
    makes from it (atol 1e-6; `tanfov` is per view in the port), with the
    caption."""
    for i, sub in enumerate(("000", os.path.join("nested", "001"))):
        _chunk(str(tmp_path / "raw" / sub), seed=i)
    outs = [str(tmp_path / n) for n in ("port", "jax")]
    assert raw.convert_raw_dir(str(tmp_path / "raw"), outs[0], 4, "png") \
        == jraw.convert_raw_dir(str(tmp_path / "raw"), outs[1], 4, "png") \
        == 2
    assert sorted(os.listdir(outs[0])) == sorted(os.listdir(outs[1])) == [
        "000.caption.txt", "000.npz", "nested_001.caption.txt",
        "nested_001.npz"]
    for name in sorted(os.listdir(outs[0])):
        a, b = (os.path.join(o, name) for o in outs)
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                _equal(dict(za), dict(zb))
        else:
            assert open(a).read() == open(b).read()
    kw = dict(n_views_in=2, n_views_sup=2, n_points=256, seed=4)
    got = gbuffer.MultiViewDataset(outs[0], **kw).batch(2)
    ref = jgbuffer.MultiViewDataset(outs[1], **kw).batch(2)
    assert got["caption"] == ref["caption"]
    assert got["caption"][0].startswith("a test object")
    for k, v in ref.items():
        if k in ("caption", "tanfov"):
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-6,
                                   err_msg=k)
    assert got["images_in"].shape[:3] == (2, 2, 15)
