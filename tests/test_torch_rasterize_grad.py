"""The port's rasterizer gradients against the JAX package's on the CPU:
the analytic chunk adjoint (`chunk_backward`), the frame's reverse walk
behind `rasterize_tiled(impl="cuda")` (on CPU tensors the plain pair the
backward kernel K2b is held to on the card), and the per-pixel oracle.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.ops import rasterize as jrz
from gaussiananything_tpu.ops.rasterize_pallas import rasterize_tiled_v4_train
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.ops import rasterize_cuda
from test_torch_rasterize import scene, t, translucent_scene

torch.set_num_threads(2)

MAPS = ("image", "alpha", "depth_expected", "depth_median", "dist",
        "normal_view")


def _chunk_case(seed: int, G: int = 3, P: int = 16, K: int = 32):
    """The inputs of tests/test_chunk_backward.py:18-39, as numpy."""
    rng = np.random.default_rng(seed)
    data = np.zeros((rz.PACKED_F, G, K), np.float32)
    data[0:9] = rng.normal(size=(9, G, K)) * 0.05
    data[9:12] = rng.normal(size=(3, G, K)) * 0.01
    data[11] += 2.0
    data[12] = rng.uniform(0, 4, (G, K))
    data[13] = rng.uniform(0, 4, (G, K))
    data[14] = rng.uniform(1.0, 3.0, (G, K))
    data[15] = rng.uniform(0, 1, (G, K))
    data[16:22] = rng.normal(size=(6, G, K)) * 0.5 + 0.3
    px = rng.uniform(0, 4, (G, P)).astype(np.float32)
    py = rng.uniform(0, 4, (G, P)).astype(np.float32)
    state = {f: np.zeros((G, P, 3) if f in ("rgb", "normal") else (G, P),
                         np.float32) for f in rz.PixelState._fields}
    state["trans"] = rng.uniform(0.3, 1.0, (G, P)).astype(np.float32)
    state["alpha_acc"] = rng.uniform(0, 0.5, (G, P)).astype(np.float32)
    state["dist_d"] = rng.uniform(0, 0.3, (G, P)).astype(np.float32)
    state["dist_d2"] = rng.uniform(0, 0.2, (G, P)).astype(np.float32)
    ct = {f: rng.normal(size=state[f].shape).astype(np.float32)
          for f in rz.PixelState._fields}
    return state, px, py, data, ct


def _pstate(d):
    return rz.PixelState(**{k: t(v) for k, v in d.items()})


def _jstate(d):
    return jrz.PixelState(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_backward_matches_jax(seed):
    """`chunk_backward` vs `rz._chunk_backward`, rtol 1e-4 (the same
    expressions; products and cumulative sums in another order)."""
    state, px, py, data, ct = _chunk_case(seed)
    ref_s, ref_d = jax.jit(jrz._chunk_backward)(
        _jstate(state), jnp.asarray(px), jnp.asarray(py), jnp.asarray(data),
        _jstate(ct))
    got_s, got_d = rz.chunk_backward(_pstate(state), t(px), t(py), t(data),
                                     _pstate(ct))
    for name in rz.PixelState._fields:
        np.testing.assert_allclose(
            getattr(got_s, name).numpy(), np.asarray(getattr(ref_s, name)),
            rtol=1e-4, atol=1e-5, err_msg=f"state ct: {name}")
    ref_d = np.asarray(ref_d)
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_d).max() + 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_backward_matches_autograd(seed):
    """The analytic adjoint against autograd through `composite_chunk`, as
    tests/test_chunk_backward.py:42-57 does in JAX."""
    state, px, py, data, ct = _chunk_case(seed)
    st = rz.PixelState(*(x.requires_grad_(True) for x in _pstate(state)))
    d = t(data).requires_grad_(True)
    out = rz.composite_chunk(st, t(px), t(py), d)
    ref = torch.autograd.grad(list(out), list(st) + [d],
                              [t(ct[f]) for f in rz.PixelState._fields],
                              allow_unused=True)
    got_s, got_d = rz.chunk_backward(_pstate(state), t(px), t(py), t(data),
                                     _pstate(ct))
    for name, r, g in zip(rz.PixelState._fields, ref, got_s):
        r = torch.zeros_like(g) if r is None else r
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5, msg=name)
    torch.testing.assert_close(
        got_d, ref[-1], rtol=1e-4,
        atol=1e-4 * float(ref[-1].abs().max() + 1))


def _weights(seed, res):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=(res, res, 3) if k in ("image", "normal_view")
                        else (res, res)).astype(np.float32) for k in MAPS}


def _jax_loss(render, wts):
    def loss(gg):
        out = render(gg)
        return sum(jnp.sum(out[k] * wts[k]) for k in MAPS)
    return loss


def _port_grad(g, cam, res, mpt, chunk, wts, impl="cuda"):
    gg = t(g).requires_grad_(True)
    out = rz.rasterize_tiled(gg, t(cam["cam_view"][0]),
                             t(cam["cam_view_proj"][0]), torch.ones(3), res,
                             res, max_per_tile=mpt, chunk=chunk, impl=impl)
    loss = sum((out[k] * t(np.moveaxis(
        wts[k].reshape(res, res, -1), -1, 0))).sum() for k in MAPS)
    loss.backward()
    return float(loss.detach()), gg.grad.numpy()


# (scene, image size, max_per_tile, chunk): opaque scenes, and the
# translucent close-range one where dist (and its gradient) is far above
# its fp32 floor and every tile spans several chunks
GRAD_CASES = {
    "sphere-32": (lambda: scene(0, 128, "sphere"), 32, 128, 64),
    "big-splats-64": (lambda: scene(3, 512, None), 64, 256, 64),
    "dist-scene-64": (lambda: translucent_scene(0, 1024, "sphere", 0.6, 0.2),
                      64, 512, 32),
}


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_rasterizer_gradient_matches_jax_xla(name):
    """d(Σ every map · random weights)/d(surfels) through the Function on
    CPU tensors vs `jax.grad(rz.rasterize_tiled)`: rtol 2e-3 / atol 2e-4
    of tests/test_pallas_kernel.py:164 scaled by the gradient's size (the
    weights are N(0,1) on every map, not image² + dist)."""
    make, res, mpt, chunk = GRAD_CASES[name]
    g, cam = make()
    wts = _weights(7, res)
    if name.startswith("dist"):
        wts["dist"] *= 100.0        # the trainer's dist_weight

    def jax_grad(w):
        return np.asarray(jax.grad(_jax_loss(lambda gg: jrz.rasterize_tiled(
            gg, cam["cam_view"][0], cam["cam_view_proj"][0],
            cam["tanfov"][0], jnp.ones(3), res, res, tile=16,
            max_per_tile=mpt, chunk=chunk, tile_group=4), w))(jnp.asarray(g)))

    ref = jax_grad(wts)
    _, got = _port_grad(g, cam, res, mpt, chunk, wts)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4 * scale)
    if name.startswith("dist"):
        # dist's own gradient: a visible part of the total (or the check
        # above says nothing about it), and held to JAX's on its own
        only = {k: (v if k == "dist" else 0 * v) for k, v in wts.items()}
        _, g_dist = _port_grad(g, cam, res, mpt, chunk, only)
        assert np.linalg.norm(g_dist) >= 1e-3 * np.linalg.norm(got)
        ref_dist = jax_grad(only)
        np.testing.assert_allclose(
            g_dist, ref_dist, rtol=2e-3,
            atol=2e-3 * float(np.abs(ref_dist).max()))


def test_rasterizer_gradient_matches_jax_pallas_pair():
    """The same against the TPU kernel pair itself in interpret mode
    (`rasterize_tiled_v4_train`, its step budget large enough not to
    truncate)."""
    g, cam = scene(0, 128, "sphere")
    res, mpt, chunk = 32, 128, 64
    wts = _weights(8, res)
    ref = jax.grad(_jax_loss(lambda gg: rasterize_tiled_v4_train(
        gg, cam["cam_view"][0], cam["cam_view_proj"][0], cam["tanfov"][0],
        jnp.ones(3), res, res, tile=16, max_per_tile=mpt, chunk=chunk,
        group=2, steps_per_group=float(mpt // chunk), interpret=True),
        wts))(jnp.asarray(g))
    ref = np.asarray(ref)
    _, got = _port_grad(g, cam, res, mpt, chunk, wts)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4 * scale)


def test_function_matches_autograd_through_plain_compositor():
    """A third opinion: autograd through `composite_plain`'s chunks."""
    g, cam = scene(3, 512, None)
    res, mpt, chunk = 64, 256, 64
    wts = _weights(9, res)
    gg = t(g).requires_grad_(True)
    sp = rz.preprocess_splats(gg, t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), res, res)
    with torch.no_grad():
        pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, mpt)
    tab = rz.splat_table(sp, res, res)
    out = rz.split_outputs(rz.composite_plain(
        tab, pairs, starts, counts, torch.ones(3), res, res, chunk=chunk))
    sum((out[k] * t(np.moveaxis(wts[k].reshape(res, res, -1), -1, 0))).sum()
        for k in MAPS).backward()
    _, got = _port_grad(g, cam, res, mpt, chunk, wts)
    _, got_plain = _port_grad(g, cam, res, mpt, chunk, wts, impl="plain")
    np.testing.assert_array_equal(got, got_plain)
    ref = gg.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_entries_are_the_chunk_entry_states():
    """`composite_plain(return_entries=True)`: row `chunk_offsets[t] + c`
    holds tile t's (T, Σw, D, D2) on entry to chunk c, the first chunk's
    is the initial state, a tile executes ceil(count / chunk) chunks unless
    it saturates first, and the buffer is the one without entries; the
    marks of a row set bits only below its chunk's slot count and none in
    the rows of chunks a tile skips."""
    g, cam = translucent_scene(0, 1024, "sphere", 0.6, 0.2)
    res, chunk = 64, 32
    sp = rz.preprocess_splats(t(g), t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), res, res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, 512)
    tab = rz.splat_table(sp, res, res)
    args = (tab, pairs, starts, counts, torch.ones(3), res, res)
    buf, entries, n_exec, marks = rz.composite_plain(*args, chunk=chunk,
                                                     return_entries=True)
    torch.testing.assert_close(buf, rz.composite_plain(*args, chunk=chunk),
                               rtol=0, atol=0)
    offs = rz.chunk_offsets(counts, chunk)
    n_chunks = (counts + chunk - 1) // chunk
    assert entries.shape == (int(offs[-1]), 4, 256)
    assert (n_exec <= n_chunks).all() and int(n_exec.max()) > 1
    first = entries[offs[:-1][counts > 0].long()]
    assert (first[:, 0] == 1).all() and (first[:, 1:] == 0).all()
    # the second chunk's entry is the state after compositing the first
    tile = int(torch.argmax(n_exec))
    cut = counts.clone()
    cut[tile] = chunk
    after_one = rz.split_outputs(rz.composite_plain(
        tab, pairs, starts, cut, torch.ones(3), res, res, chunk=chunk))
    ty, tx = divmod(tile, res // 16)
    alpha = after_one["alpha"][0, ty * 16:ty * 16 + 16,
                               tx * 16:tx * 16 + 16].reshape(-1)
    torch.testing.assert_close(entries[int(offs[tile]) + 1, 1], alpha)
    # marks: (rows, 8 warps, 4 words), bits below each chunk's slot count
    assert marks.shape == (int(offs[-1]), 8, rz.MARK_WORDS)
    bits = (marks[..., None] >> torch.arange(32)) & 1           # int32
    bits = bits.reshape(len(marks), 8, -1)
    for ti in range(len(counts)):
        for c in range((int(counts[ti]) + chunk - 1) // chunk):
            row = bits[int(offs[ti]) + c]
            live = min(chunk, int(counts[ti]) - c * chunk)
            assert int(row[:, live:].sum()) == 0
            if c >= int(n_exec[ti]):
                assert int(row.sum()) == 0
    assert int(bits.sum()) > 0


def test_warp_marks_packs_each_warps_blending_slots():
    """Pixel (x, y) of a 16² tile lies in warp (y // 4) · 2 + x // 8, as
    the kernels lay their warps out; slot k sets bit k % 32 of word k /
    32, bit 31 as the int32 sign."""
    w = torch.zeros(2, 256, 40)
    w[0, 0, 0] = 1.0               # (0, 0): warp 0, slot 0
    w[0, 255, 39] = 0.5            # (15, 15): warp 7, slot 39
    w[1, 8, 31] = 1.0              # (8, 0): warp 1, slot 31
    w[1, 16 * 5 + 3, 2] = -0.0     # no weight above zero: no bit
    m = rz.warp_marks(w, 16, 4)
    want = torch.zeros(2, 8, 4, dtype=torch.int32)
    want[0, 0, 0] = 1
    want[0, 7, 1] = 1 << 7
    want[1, 1, 0] = -2 ** 31
    assert torch.equal(m, want)


def test_splat_order_lists_each_live_pair_once():
    g, cam = scene(3, 512, None)
    sp = rz.preprocess_splats(t(g), t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), 64, 64)
    pairs, starts, counts = rz.build_tile_pairs(sp, 64, 64, 16, 64)
    order, seg = rasterize_cuda.splat_order(pairs, starts, counts, 512)
    live = torch.zeros(len(pairs), dtype=torch.bool)
    for s0, c in zip(starts.tolist(), counts.tolist()):
        live[s0:s0 + c] = True
    sel = order[:int(seg[-1])].long()
    assert int(seg[-1]) == int(live.sum()) == int(counts.sum())
    assert live[sel].all() and len(set(sel.tolist())) == len(sel)
    for s in (0, 17, 511):
        run = sel[int(seg[s]):int(seg[s + 1])]
        assert (pairs[run] == s).all()
        assert (run[1:] > run[:-1]).all()       # stable: ascending position


@pytest.mark.parametrize("mpt,chunk", [(64, 16), (512, 32), (512, 128)])
def test_max_entry_rows_bounds_the_chunks_from_shapes(mpt, chunk):
    """K2a sizes its entries buffer without reading the counts: the bound
    holds with tiles capped, tiles at their cap and empty tiles."""
    g, cam = scene(3, 512, None)
    sp = rz.preprocess_splats(t(g), t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), 64, 64)
    pairs, starts, counts = rz.build_tile_pairs(sp, 64, 64, 16, mpt)
    need = int(rz.chunk_offsets(counts, chunk)[-1])
    assert 0 < need <= rz.max_entry_rows(pairs.shape[0], 16, chunk)
    full = torch.full((16,), 1000, dtype=torch.int32)
    assert int(rz.chunk_offsets(full, chunk)[-1]) \
        <= rz.max_entry_rows(16 * 1000, 16, chunk)


@pytest.mark.parametrize("seed,n,kind,res", [(0, 256, "sphere", 32),
                                             (3, 256, None, 32)])
def test_rasterize_naive_matches_jax(seed, n, kind, res):
    g, cam = scene(seed, n, kind)
    ref = jrz.rasterize_naive(jnp.asarray(g), cam["cam_view"][0],
                              cam["cam_view_proj"][0], cam["tanfov"][0], res,
                              res, jnp.ones(3), chunk=64, pixel_block=256)
    got = rz.rasterize_naive(t(g), t(cam["cam_view"][0]),
                             t(cam["cam_view_proj"][0]), torch.ones(3), res,
                             res, chunk=64, pixel_block=256)
    for k in MAPS:
        np.testing.assert_allclose(
            got[k].numpy(),
            np.moveaxis(np.asarray(ref[k]).reshape(res, res, -1), -1, 0),
            atol=2e-5, rtol=1e-4, err_msg=k)


def test_active_steps_counts_the_blending_steps():
    """`active_steps`: the (pixel, pair) steps with a weight above zero.
    Every covered pixel has one at least, no frame has more than pixels x
    pairs, the count does not depend on where the chunks are cut (but for
    knife-edge steps: 1e-3 of it), and an empty frame has none."""
    g, cam = translucent_scene(0, 1024, "sphere", 0.6, 0.2)
    res = 64
    sp = rz.preprocess_splats(t(g), t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), res, res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, 512)
    tab = rz.splat_table(sp, res, res)
    n32 = rz.active_steps(tab, pairs, starts, counts, res, res, chunk=32)
    n512 = rz.active_steps(tab, pairs, starts, counts, res, res, chunk=512)
    alpha = rz.split_outputs(rz.composite_plain(
        tab, pairs, starts, counts, torch.ones(3), res, res, chunk=32))["alpha"]
    assert int((alpha > 0).sum()) <= n32 <= 256 * int(counts.sum())
    assert abs(n32 - n512) <= 1e-3 * n512
    assert rz.active_steps(tab, pairs, starts, 0 * counts, res, res) == 0


def test_impl_cuda_picks_the_wrapper_by_whether_a_gradient_is_wanted(
        monkeypatch):
    """`impl="cuda"` goes through the differentiable wrapper (K2a + K2b on
    the card) only where autograd will ask for a gradient, and through the
    forward-only one (K1) otherwise; there is no third name to get wrong."""
    g, cam = scene(0, 128, "sphere")
    called = []
    for name in ("composite", "composite_train"):
        fn = getattr(rasterize_cuda, name)
        monkeypatch.setattr(
            rasterize_cuda, name,
            lambda *a, _fn=fn, _name=name, **k: (called.append(_name),
                                                 _fn(*a, **k))[1])

    def render(gg, impl="cuda"):
        return rz.rasterize_tiled(gg, t(cam["cam_view"][0]),
                                  t(cam["cam_view_proj"][0]), torch.ones(3),
                                  32, 32, max_per_tile=128, chunk=64,
                                  impl=impl)

    out = render(t(g).requires_grad_(True))
    assert out["image"].requires_grad
    with torch.no_grad():
        quiet = render(t(g).requires_grad_(True))
    plain = render(t(g))
    assert called == ["composite_train", "composite", "composite"]
    assert not quiet["image"].requires_grad
    torch.testing.assert_close(out["image"].detach(), plain["image"],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown rasterizer impl"):
        render(t(g), impl="cuda_nograd")
