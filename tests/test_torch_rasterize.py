"""The port's rasterizer against the JAX package's: projection, binning,
packing, the plain compositor (K1's counterpart) and the multi-view
renderer. Both sides get the same surfels (numpy draws) and the same camera
matrices, so every difference is the rasterizer's own.

Compositor tolerance atol 2e-5 / rtol 1e-4: the v4-kernel-vs-XLA bound of
`tests/test_pallas_kernel.py:116-119` (the same per-pair expressions, with
transmittance products and chunk sums taken in another order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.data.synthetic import make_object as jmake_object
from gaussiananything_tpu.ops import rasterize as jrz
from gaussiananything_tpu.ops.rasterize_pallas import rasterize_tiled_v4
from gaussiananything_tpu.render import cameras as jcameras
from gaussiananything_tpu.render.renderer import \
    render_multiview as jrender_multiview
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.ops import rasterize_cuda
from gaussiananything_tpu_torch.render.renderer import (GaussianRenderer2DGS,
                                                        render_multiview)

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)
# (seed, n, kind, image size); seed 3 is the big-splat scene
SCENES = [(0, 512, "sphere", 32), (0, 512, "sphere", 64),
          (3, 1024, None, 64), (0, 2048, "sphere", 128)]
# Translucent shells seen from close range (seed, n, kind, camera radius,
# opacity, image size). dist is built from squared gaps of the mapped depth
# m(z), dm/dz = 0.01/z², so in SCENES it is ~4e-7: under the ~7e-7 fp32
# floor of its running sums (terms of ~1 that cancel) and far under TOL's
# atol. Here it reaches 1e-4 and more, with each tile's segment spread over
# several chunks, so the entry-state cross terms carry most of it.
DIST_SCENES = [(0, 2048, "sphere", 0.6, 0.2, 64),
               (3, 1024, None, 0.6, 0.2, 64)]
DIST_REL, DIST_FLOOR = 2e-2, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def scene(seed, n, kind, poses=((20, 45),)):
    g = np.asarray(jmake_object(seed, n=n, kind=kind))
    cam = jcameras.pose_to_gs_camera(
        jnp.asarray(jcameras.generate_input_camera(1.8, list(poses))))
    return g, cam


def translucent_scene(seed, n, kind, radius, opacity):
    g = np.asarray(jmake_object(seed, n=n, kind=kind)).copy()
    g[:, 3] = opacity
    cam = jcameras.pose_to_gs_camera(
        jnp.asarray(jcameras.generate_input_camera(radius, [(20, 45)])))
    return g, cam


def assert_dist_close(got, ref):
    """dist to DIST_REL of its largest value, which must be DIST_FLOOR or
    more: measured parity noise is 0.3-0.5% of it, while a zero dist or one
    without the entry-state cross terms is off by 80-100%."""
    ref = np.asarray(ref)
    peak = float(np.abs(ref).max())
    assert peak >= DIST_FLOOR, f"dist peaks at {peak}, under {DIST_FLOOR}"
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= DIST_REL * peak, f"dist error {err} of peak {peak}"


def projected(seed, n, kind, img):
    g, cam = scene(seed, n, kind)
    jsp = jrz.preprocess_splats(jnp.asarray(g), cam["cam_view"][0],
                                cam["cam_view_proj"][0], img, img,
                                cam["tanfov"][0])
    sp = rz.preprocess_splats(t(g), t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), img, img)
    return jsp, sp


def as_port(jsp) -> rz.SplatProj:
    return rz.SplatProj(*(t(getattr(jsp, f)) for f in jsp._fields))


def to_channel_first(a):
    a = np.asarray(a)
    return np.moveaxis(a, -1, 0) if a.ndim == 3 else a[None]


@pytest.mark.parametrize("seed,n,kind,img", SCENES)
def test_preprocess_splats(seed, n, kind, img):
    """Componentwise fp32 in one expression order; the conic AABB's sqrt
    amplifies ulps, hence 1e-5 relative to the field's scale."""
    jsp, sp = projected(seed, n, kind, img)
    for f in jsp._fields:
        a, b = np.asarray(getattr(jsp, f)), getattr(sp, f).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(
                b, a, atol=1e-5 * max(1.0, float(np.abs(a).max())),
                err_msg=f)


@pytest.mark.parametrize("seed,n,kind,img", SCENES)
@pytest.mark.parametrize("row0,big_capacity", [(0, 0), (0, 8), (16, 0)])
def test_build_tile_pairs_integer_equal(seed, n, kind, img, row0,
                                        big_capacity):
    """Same SplatProj in, the same (pairs, starts, counts) out: the 2×2 and
    6×6 windows, the capacity overflow fallback (big_capacity 8), the
    centre-anchored clamp, the max_per_tile cap and the row0 offset."""
    jsp, _ = projected(seed, n, kind, img)
    jp, js, jc = jrz.build_tile_pairs(jsp, img, img, 16, 128, row0=row0,
                                      big_capacity=big_capacity)
    p, s, c = rz.build_tile_pairs(as_port(jsp), img, img, 16, 128,
                                  row0=row0, big_capacity=big_capacity)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    jp = np.asarray(jp)
    for tile in range(len(s)):
        a, k = int(s[tile]), int(c[tile])
        np.testing.assert_array_equal(p[a:a + k].numpy(), jp[a:a + k])


def test_pack_splat_render():
    jsp, _ = projected(3, 1024, None, 64)
    np.testing.assert_array_equal(rz.pack_splat_render(as_port(jsp)).numpy(),
                                  np.asarray(jrz.pack_splat_render(jsp)))


@pytest.mark.parametrize("seed,n,kind,img", SCENES)
def test_plain_compositor_matches_rasterize_tiled(seed, n, kind, img):
    g, cam = scene(seed, n, kind)
    cv, cvp = cam["cam_view"][0], cam["cam_view_proj"][0]
    ref = jrz.rasterize_tiled(jnp.asarray(g), cv, cvp, cam["tanfov"][0],
                              jnp.ones(3), img, img, tile=16,
                              max_per_tile=256, chunk=64, tile_group=4)
    got = rz.rasterize_tiled(t(g), t(cv), t(cvp), torch.ones(3), img, img,
                             tile=16, max_per_tile=256, chunk=64)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), to_channel_first(ref[k]),
                                   err_msg=k, **TOL)


def test_plain_compositor_matches_v4_interpret():
    """K1's counterpart against the Pallas v4 kernel itself (interpret
    mode, the step budget of `test_v4_matches_xla_interpret`)."""
    g, cam = scene(3, 1024, None)
    cv, cvp = cam["cam_view"][0], cam["cam_view_proj"][0]
    ref = rasterize_tiled_v4(jnp.asarray(g), cv, cvp, cam["tanfov"][0],
                             jnp.ones(3), 64, 64, tile=16, max_per_tile=256,
                             chunk=64, group=4, steps_per_group=4.0)
    got = rz.rasterize_tiled(t(g), t(cv), t(cvp), torch.ones(3), 64, 64,
                             tile=16, max_per_tile=256, chunk=64)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), to_channel_first(ref[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("seed,n,kind,radius,opacity,img", DIST_SCENES)
def test_plain_compositor_dist_matches_rasterize_tiled(seed, n, kind, radius,
                                                       opacity, img):
    """Every map at TOL, and dist held to its own size."""
    g, cam = translucent_scene(seed, n, kind, radius, opacity)
    cv, cvp = cam["cam_view"][0], cam["cam_view_proj"][0]
    ref = jrz.rasterize_tiled(jnp.asarray(g), cv, cvp, cam["tanfov"][0],
                              jnp.ones(3), img, img, tile=16,
                              max_per_tile=256, chunk=64, tile_group=4)
    got = rz.rasterize_tiled(t(g), t(cv), t(cvp), torch.ones(3), img, img,
                             tile=16, max_per_tile=256, chunk=64)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), to_channel_first(ref[k]),
                                   err_msg=k, **TOL)
    assert_dist_close(got["dist"].numpy(), to_channel_first(ref["dist"]))


def test_plain_compositor_dist_matches_v4_interpret():
    """dist held to its own size against the Pallas v4 kernel."""
    seed, n, kind, radius, opacity, img = DIST_SCENES[0]
    g, cam = translucent_scene(seed, n, kind, radius, opacity)
    cv, cvp = cam["cam_view"][0], cam["cam_view_proj"][0]
    ref = rasterize_tiled_v4(jnp.asarray(g), cv, cvp, cam["tanfov"][0],
                             jnp.ones(3), img, img, tile=16, max_per_tile=256,
                             chunk=64, group=4, steps_per_group=4.0)
    got = rz.rasterize_tiled(t(g), t(cv), t(cvp), torch.ones(3), img, img,
                             tile=16, max_per_tile=256, chunk=64)
    assert_dist_close(got["dist"].numpy(), to_channel_first(ref["dist"]))


@pytest.mark.parametrize("mutation", ["zero", "no_cross_terms"])
def test_dist_check_rejects_a_wrong_dist(mutation, monkeypatch):
    """The dist check discriminates on DIST_SCENES: a compositor that
    writes 0, or drops the entry-state cross terms A·s_wm2 + D2·s_w −
    2D·s_wm, fails it."""
    seed, n, kind, radius, opacity, img = DIST_SCENES[0]
    g, cam = translucent_scene(seed, n, kind, radius, opacity)
    args = (t(g), t(cam["cam_view"][0]), t(cam["cam_view_proj"][0]),
            torch.ones(3), img, img)
    ref = rz.rasterize_tiled(*args, max_per_tile=256, chunk=64)["dist"]
    chunk_fn = rz.composite_chunk

    def wrong(state, px, py, data):
        out = chunk_fn(state, px, py, data)
        if mutation == "zero":
            return out._replace(dist=torch.zeros_like(out.dist))
        s_w = out.alpha_acc - state.alpha_acc
        s_wm = out.dist_d - state.dist_d
        s_wm2 = out.dist_d2 - state.dist_d2
        return out._replace(dist=state.dist + (s_w * s_wm2 - s_wm * s_wm))

    monkeypatch.setattr(rz, "composite_chunk", wrong)
    got = rz.rasterize_tiled(*args, max_per_tile=256, chunk=64)["dist"]
    with pytest.raises(AssertionError, match="dist error"):
        assert_dist_close(got.numpy(), ref.numpy())


def test_render_multiview_matches():
    """World normals, the depth_expected gate, the clip and the (B, V, C,
    H, W) layout of the JAX `render_multiview(impl="xla")`."""
    gs = np.stack([np.asarray(jmake_object(s, n=512, kind="sphere"))
                   for s in (0, 5)])
    _, cam = scene(0, 1, "sphere", poses=((20, 45), (-30, 160), (60, 300)))
    cv = jnp.broadcast_to(cam["cam_view"][None], (2, 3, 4, 4))
    cvp = jnp.broadcast_to(cam["cam_view_proj"][None], (2, 3, 4, 4))
    bg = np.random.default_rng(0).uniform(size=(2, 3, 3)).astype(np.float32)
    ref = jrender_multiview(jnp.asarray(gs), cv, cvp,
                            jnp.broadcast_to(cam["tanfov"][None], (2, 3)),
                            jnp.asarray(bg), 48, 16, 256, 64, 9, impl="xla")
    got = render_multiview(t(gs), t(cv), t(cvp), t(bg), 48, tile=16,
                           max_per_tile=256, chunk=64, impl="plain")
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    renderer = GaussianRenderer2DGS(output_size=48, max_per_tile=256,
                                    chunk=64)
    again = renderer.render(t(gs), t(cv), t(cvp), bg_color=t(bg))
    for k in got:
        torch.testing.assert_close(again[k], got[k], atol=0, rtol=0)


def test_k1_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the K1 wrapper computes the plain version and counts
    no launch."""
    g, cam = scene(0, 512, "sphere")
    sp = rz.preprocess_splats(t(g), t(cam["cam_view"][0]),
                              t(cam["cam_view_proj"][0]), 32, 32)
    pairs, starts, counts = rz.build_tile_pairs(sp, 32, 32, 16, 256)
    tab = rz.splat_table(sp, 32, 32)
    before = rasterize_cuda.composite.launches
    got = rasterize_cuda.composite(tab, pairs, starts, counts,
                                   torch.ones(3), 32, 32)
    ref = rz.composite_plain(tab, pairs, starts, counts, torch.ones(3),
                             32, 32)
    assert rasterize_cuda.composite.launches == before
    torch.testing.assert_close(got, ref, atol=0, rtol=0)

