"""The JAX package's matmul precision policy in the port, proved on the CPU.

On an H100 the JAX package computes its networks' products at
`Precision.DEFAULT` (TF32) and its named geometry products at
`Precision.HIGHEST` (IEEE fp32). The port sets the same policy
(`utils.device.resolve_device`, `utils.precision`); the card's numbers
cannot be asked here, so `tests/torch_tf32.py`'s emulator rounds every
fp32 product operand to TF32 where the policy flag that cuBLAS or cuDNN
would read says "tf32". Under the "default" policy:

* every HIGHEST site of the site map (`utils/precision.py`) is bit-equal
  with the emulator on and off, forward and backward, and every product
  the emulator sees there reads "ieee"; with one site's wrapper
  monkeypatched back to the plain product the same comparison fails;
* the DEFAULT networks (a DiT block, a DINOv2 block, the SD-encoder
  trunk) move under the emulator and stay within relative Frobenius 1e-2
  of the JAX function on the same numpy inputs: TF32 rounds an operand by
  at most 2^-11 (4.9e-4) relative, and 1e-2 allows a 20x growth through a
  block;
* under bf16 compute the attention scores are fp32 products of bf16
  values, which TF32 holds exactly: the emulated `_attend` equals the
  IEEE one bit for bit here (on the card, within fp32 summation order).
"""
from __future__ import annotations

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.models import dinov2 as jdinov2
from gaussiananything_tpu.models import layers as jlayers
from gaussiananything_tpu.models.dit import PointDiT as JPointDiT
from gaussiananything_tpu.models.sd_encoder import \
    SDEncoderTrunk as JSDEncoderTrunk
from gaussiananything_tpu_torch.data import postprocess as post
from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.sd_encoder import SDEncoderTrunk
from gaussiananything_tpu_torch.ops import pointcloud
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.utils import image, precision
from gaussiananything_tpu_torch.utils.device import resolve_device
from test_torch_models import carry, japply, randomize, t
from torch_tf32 import TF32Emulator, round_tf32

torch.set_num_threads(2)

NET_REL = 1e-2          # relative Frobenius, port under TF32 vs JAX
W, HEADS = 128, 2


@pytest.fixture(autouse=True)
def default_policy():
    resolve_device("cpu")
    yield
    resolve_device("cpu")


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out.detach()]
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _flat(out[k])]
    return [v for o in out for v in _flat(o)]


def _both(fn):
    """fn() with the emulator off and on (the "default" policy): the two
    flat output lists and the emulator's log."""
    off = _flat(fn())
    with TF32Emulator() as mode:
        on = _flat(fn())
    return off, on, mode.log


def _bit_equal(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / np.linalg.norm(ref))


# ---- the policy ---------------------------------------------------------

def test_resolve_device_sets_the_policy():
    """Replaces the test that pinned IEEE for every product: the JAX
    package computes its networks at `Precision.DEFAULT`, TF32 on an
    H100."""
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    resolve_device("cpu", matmul_precision="highest")
    assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    assert torch.backends.cudnn.conv.fp32_precision == "ieee"
    with pytest.raises(ValueError, match="matmul_precision"):
        resolve_device("cpu", matmul_precision="high")


def _wrapper_cases():
    r = np.random.default_rng(0)
    a, b = t(r.normal(size=(3, 5, 4))), t(r.normal(size=(3, 4, 6)))
    m = t(r.normal(size=(2, 4, 4)) + 4 * np.eye(4))
    return {
        "matmul": (precision.highest_matmul, torch.matmul, (a, b[0])),
        "bmm": (precision.highest_bmm, torch.bmm, (a, b)),
        "einsum": (lambda x, y: precision.highest_einsum(
            "bij,bjk->bik", x, y),
            lambda x, y: torch.einsum("bij,bjk->bik", x, y), (a, b)),
        "inv": (precision.highest_inv, torch.linalg.inv, (m,)),
    }


@pytest.mark.parametrize("name", ["matmul", "bmm", "einsum", "inv"])
def test_highest_pins_ieee_forward_and_backward(name):
    """Under the "default" policy every product of a `highest_*` call,
    forward and backward, reads "ieee", the flag is "tf32" again after
    it, and value and gradient are the plain op's (IEEE on the CPU)."""
    fn, plain, args = _wrapper_cases()[name]
    ins = [a.clone().requires_grad_(True) for a in args]
    with TF32Emulator() as mode:
        out = fn(*ins)
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        out.square().sum().backward()
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    if name != "inv":          # the inverse is LAPACK, no product op
        assert mode.log and {f for _, f in mode.log} == {"ieee"}
    ref_ins = [a.clone().requires_grad_(True) for a in args]
    ref = plain(*ref_ins)
    ref.square().sum().backward()
    assert torch.equal(out.detach(), ref.detach())
    for x, y in zip(ins, ref_ins):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-6, atol=1e-6)


def test_highest_holds_ieee_while_other_threads_set_the_policy():
    """The policy is process-wide: more threads than cores run HIGHEST
    products while the main thread sets the policy back and forth, the
    interpreter switching threads every microsecond; every product of
    every worker reads "ieee" (`set_policy` waits for the lock a HIGHEST
    launch holds)."""
    a = t(np.random.default_rng(1).normal(size=(2, 8, 8)))
    stop = threading.Event()
    logs = []

    def worker():
        with TF32Emulator() as mode:
            while not stop.is_set():
                precision.highest_bmm(a, a)
        logs.append(mode.log)

    threads = [threading.Thread(target=worker)
               for _ in range((os.cpu_count() or 1) + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for i in range(400):
            precision.set_policy("default" if i % 2 else "highest")
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(logs) == len(threads)
    assert all(log and {f for _, f in log} == {"ieee"} for log in logs)


def test_round_tf32_is_round_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 + 2 ** -20, -(1 + 2 ** -11),
                      float("inf"), float("nan")])
    got = round_tf32(x).tolist()
    assert got[:5] == [1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -10, -1.0]
    assert got[5] == float("inf") and np.isnan(got[6])


# ---- HIGHEST sites: bit-equal under the emulator ------------------------

def _poses(n=3, seed=0):
    return cameras.sample_uniform_cameras_on_sphere(
        np.random.default_rng(seed), n)


def _cameras():
    return cameras.pose_to_gs_camera(_poses())


def _plucker():
    p = torch.from_numpy(_poses(2))
    return cameras.plucker_rays(p[:, :16].reshape(2, 4, 4),
                                p[:, 16:].reshape(2, 3, 3), 12, 10)


def _backproject():
    r = np.random.default_rng(2)
    depth = t(r.uniform(1.0, 2.5, (2, 1, 9, 11))).requires_grad_(True)
    p = torch.from_numpy(_poses(2))
    xyz = post.backproject_depth(depth, p[:, :16].reshape(2, 4, 4),
                                 torch.tensor([0.27, 0.31]))
    (xyz * t(r.normal(size=xyz.shape))).sum().backward()
    return xyz, depth.grad


def _encoder_input():
    r = np.random.default_rng(3)
    B, V, H = 1, 2, 8
    maps = [t(r.uniform(size=(B, V, c, H, H))) for c in (3, 3, 1, 1)]
    return post.assemble_encoder_input(
        *maps, torch.from_numpy(_poses(V)).reshape(B, V, 25))


def _canonical():
    """`canonicalize_poses` and `canonicalize_pts`, whose rebase and point
    move are HIGHEST; their rigid transform's `fixed @ inv(c2w)` is
    DEFAULT, as in JAX, so it is computed in IEEE in both runs here."""
    p = torch.from_numpy(_poses(3))
    pcd = t(np.random.default_rng(4).uniform(-0.4, 0.4, (50, 3)))
    transform = post._canonical_transform

    def same_transform(c2w):
        with precision.ieee():
            return transform(c2w)
    post._canonical_transform = same_transform
    try:
        return post.canonicalize_poses(p), post.canonicalize_pts(p, pcd)
    finally:
        post._canonical_transform = transform


def _resize():
    r = np.random.default_rng(5)
    x = t(r.normal(size=(2, 3, 13, 17))).requires_grad_(True)
    y = image.resize(x, (9, 24))
    (y * t(r.normal(size=y.shape))).sum().backward()
    return y, x.grad


def _pointcloud():
    r = np.random.default_rng(6)
    a = t(r.normal(size=(2, 40, 3))).requires_grad_(True)
    b = t(r.normal(size=(2, 30, 3)))
    cd = pointcloud.chamfer_distance(a, b)
    cd.sum().backward()
    return (pointcloud._sq_dists(a.detach(), b), cd, a.grad,
            pointcloud.sinkhorn_emd(a.detach(), b, iters=20))


def _scene():
    g = make_object(0, n=512, kind="sphere")
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0])
    return g, cam


def _v4_pair():
    """The plain v4 pair: forward maps and the surfel gradients through
    `composite_plain_train`."""
    res = 32
    g, cam = _scene()
    gg = g.clone().requires_grad_(True)
    out = rz.rasterize_tiled(gg, cam["cam_view"], cam["cam_view_proj"],
                             torch.ones(3), res, res, max_per_tile=256,
                             chunk=32, impl="plain")
    r = np.random.default_rng(7)
    sum((v * t(r.normal(size=v.shape))).sum()
        for _, v in sorted(out.items())).backward()
    return out, gg.grad


def _lists():
    res, tile = 32, 16
    g, cam = _scene()
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    lists, counts = rz.build_tile_lists(sp, res, res, tile, 256)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    px, py = rz.tile_pixel_tables(torch.arange(counts.shape[0]),
                                  res // tile, tile)
    return rz.composite_lists_plain(geom, feat, counts, px, py, 64)


GEOMETRY = {"cameras": _cameras, "plucker": _plucker,
            "backproject": _backproject, "encoder input": _encoder_input,
            "canonical": _canonical, "resize": _resize,
            "pointcloud": _pointcloud, "v4 plain pair": _v4_pair,
            "plain lists": _lists}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_highest_sites_are_bit_equal_under_tf32(name):
    off, on, log = _both(GEOMETRY[name])
    assert _bit_equal(on, off)
    assert log, "the emulator saw no product"
    assert {f for _, f in log} == {"ieee"}, log


def test_canonical_transform_is_default_as_in_jax():
    """`fixed @ inv(c2w)` is a plain `@` in JAX (`data/postprocess.py:83`,
    `:101`), so DEFAULT: the emulator moves it (by TF32's rounding of the
    inverse), and the whole rebase with it."""
    p = torch.from_numpy(_poses(3))
    off, on, log = _both(lambda: post.canonicalize_poses(p))
    assert not _bit_equal(on, off)
    assert ("aten.mm.default", "tf32") in log
    rel = float((on[0] - off[0]).abs().max() / off[0].abs().max())
    assert 0 < rel <= 2 ** -10


WITNESSES = {
    "v4 plain pair": (rz, "highest_bmm", torch.bmm, _v4_pair),
    "cameras": (cameras, "highest_matmul", torch.matmul, _cameras),
    "resize": (image, "highest_einsum", torch.einsum, _resize),
}


@pytest.mark.parametrize("name", list(WITNESSES))
def test_without_its_wrapper_a_site_moves_under_tf32(name, monkeypatch):
    """The witness: the site's wrapper monkeypatched back to the plain
    product, the emulator rounds it and the comparison above fails."""
    module, attr, plain, fn = WITNESSES[name]
    monkeypatch.setattr(module, attr, plain)
    off, on, log = _both(fn)
    assert not _bit_equal(on, off)
    assert any(f == "tf32" for _, f in log)


# ---- DEFAULT networks: they move, and stay near JAX ----------------------

def _dit_block():
    r = np.random.default_rng(1)
    B, N, L, C = 2, 12, 9, 96
    args = [(r.normal(size=(B, N, 3))).astype(np.float32),
            r.uniform(size=(B,)).astype(np.float32),
            (0.5 * r.normal(size=(B, L, C))).astype(np.float32),
            (0.5 * r.normal(size=(B, C))).astype(np.float32)]
    jm = JPointDiT(in_channels=3, width=W, depth=1, heads=HEADS,
                   cond_dim=C, vector_dim=C, release_parity=True)
    p = randomize(jm, 3, *map(jnp.asarray, args))
    pm = carry(p, PointDiT(in_channels=3, width=W, depth=1, heads=HEADS,
                          cond_dim=C, vector_dim=C))
    return japply(jm, p, *map(jnp.asarray, args)), \
        lambda: pm(*map(t, args))


def _dinov2_block():
    x = np.random.default_rng(0).normal(size=(2, 3, 56, 56)).astype(
        np.float32)
    jm = jdinov2.Dinov2ViT(width=W, depth=1, heads=HEADS, img_size=56)
    p = randomize(jm, 1, jnp.asarray(x))
    pm = carry(p, Dinov2ViT(width=W, depth=1, heads=HEADS, img_size=56))
    return japply(jm, p, jnp.asarray(x))[0], lambda: pm(t(x))[0]


def _sd_trunk():
    img = np.random.default_rng(6).normal(size=(1, 2, 15, 32, 32)).astype(
        np.float32)
    jimg = jnp.asarray(np.moveaxis(img, 2, -1))
    jm = JSDEncoderTrunk(ch=32)
    p = randomize(jm, 7, jimg)
    pm = carry(p, SDEncoderTrunk(ch=32))
    return japply(jm, p, jimg), lambda: pm(t(img)).permute(0, 1, 3, 4, 2)


NETWORKS = {"DiT block": _dit_block, "DINOv2 block": _dinov2_block,
            "SD-encoder trunk": _sd_trunk}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_default_networks_move_and_stay_near_jax(name):
    ref, run = NETWORKS[name]()
    with torch.no_grad():
        off, on, log = _both(run)
    assert any(f == "tf32" for _, f in log)
    assert not _bit_equal(on, off)
    assert _rel(on[0].numpy(), ref) <= NET_REL
    assert _rel(off[0].numpy(), ref) <= NET_REL


def test_bf16_attention_scores_are_exact_under_tf32():
    """bf16 q and k upcast to fp32 for the scores: TF32 holds them
    exactly, so the emulated attention equals the IEEE one (bit for bit
    here; on the card within fp32 summation order), while fp32 q, k move;
    both within 1e-2 of JAX's bf16 `dot_attention`."""
    r = np.random.default_rng(8)
    q, k, v = (r.normal(size=(2, 24, 2, 32)).astype(np.float32)
               for _ in range(3))
    bf = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    off, on, log = _both(lambda: layers.dot_attention(*bf))
    assert ("aten.bmm.default", "tf32") in log
    assert _bit_equal(on, off)
    ref = jlayers.dot_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)))
    assert _rel(on[0].float().numpy(), np.asarray(ref, np.float32)) \
        <= NET_REL
    off32, on32, _ = _both(lambda: layers.dot_attention(t(q), t(k), t(v)))
    assert not _bit_equal(on32, off32)
