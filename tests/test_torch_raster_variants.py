"""The port's other rasterizer entry points against the JAX package's: the
dense tile lists, the list compositors v1, v2, v3 (K3, K4, K5's plain
version and entry points), the segment-fed v4 forward (K6's), the fused v1
function's gradient and the stage-cut grouped kernels. Both sides get the
same surfels (numpy draws) and camera matrices; the JAX side runs its Pallas
kernels in interpret mode, as the JAX package's own tests do on the CPU.

Tolerances:
  * lists and packed inputs: equal (integers; gathers of the same floats);
  * every map of the list compositors: atol 2e-5 / rtol 1e-4, the
    kernel-vs-XLA bound of `tests/test_pallas_kernel.py:116-119` (the same
    per-pair expressions; the log-transmittance prefix sums are taken in
    another order than the kernels' doubling scan);
  * dist of the v1 kernel with aux: 2e-2 of its peak on a translucent
    close-range scene (elsewhere it is under its fp32 floor);
  * the segment-fed v4 forward: the same bound against the JAX kernel;
  * gradients: rtol 1e-3 / atol 1e-4, `tests/test_pallas_kernel.py:62`;
  * stage kernels: rtol 1e-4 / atol 2e-5 (sums over a chunk in another
    order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.pallas_bisect as bisect_row
import tools.pallas_bisect2 as bisect_field
from gaussiananything_tpu.data.synthetic import make_object as jmake_object
from gaussiananything_tpu.ops import rasterize as jrz
from gaussiananything_tpu.ops import rasterize_pallas as jrp
from gaussiananything_tpu.render import cameras as jcameras
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.ops import rasterize_cuda
from gaussiananything_tpu_torch.tools import kernel_stages

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)
DIST_REL, DIST_FLOOR = 2e-2, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def scene(seed, n, kind, radius=1.8, opacity=None):
    g = np.asarray(jmake_object(seed, n=n, kind=kind)).copy()
    if opacity is not None:
        g[:, 3] = opacity
    cam = jcameras.pose_to_gs_camera(jnp.asarray(
        jcameras.generate_input_camera(radius, [(20, 45)])[0]))
    return g, cam


def jax_args(g, cam):
    return (jnp.asarray(g), cam["cam_view"], cam["cam_view_proj"],
            cam["tanfov"], jnp.ones(3))


def port_args(g, cam):
    return (t(g), t(cam["cam_view"]), t(cam["cam_view_proj"]), torch.ones(3))


def as_port(jsp) -> rz.SplatProj:
    return rz.SplatProj(*(t(getattr(jsp, f)) for f in jsp._fields))


def to_channel_first(a):
    a = np.asarray(a)
    return np.moveaxis(a, -1, 0) if a.ndim == 3 else a[None]


def assert_maps_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), to_channel_first(ref[k]),
                                   err_msg=k, **TOL)


def jax_projected(seed, n, kind, img_h, img_w):
    g, cam = scene(seed, n, kind)
    return jrz.preprocess_splats(jnp.asarray(g), cam["cam_view"],
                                 cam["cam_view_proj"], img_h, img_w,
                                 cam["tanfov"])


# (seed, n, kind, full image, band height, row0); seed 3 is the big-splat
# scene; the last renders the lower half of a 64² image
LIST_SCENES = [(0, 512, "sphere", 64, 64, 0), (3, 1024, None, 64, 64, 0),
               (3, 1024, None, 64, 32, 32)]


@pytest.mark.parametrize("seed,n,kind,img,band,row0", LIST_SCENES)
def test_build_tile_lists_integer_equal(seed, n, kind, img, band, row0):
    jsp = jax_projected(seed, n, kind, img, img)
    jl, jc = jrz.build_tile_lists(jsp, band, img, 16, 128, row0=row0)
    lists, counts = rz.build_tile_lists(as_port(jsp), band, img, 16, 128,
                                        row0=row0)
    assert lists.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(jl))
    assert int(counts.max()) > 0 and int(lists.min()) == -1


def test_pack_tile_inputs_equal():
    """The same gathers of the same floats; a -1 entry selects the dead
    splat (row N, opacity 0)."""
    jsp = jax_projected(3, 1024, None, 64, 64)
    jl, _ = jrz.build_tile_lists(jsp, 64, 64, 16, 128)
    jpad = jax.tree.map(lambda a: jnp.concatenate(
        [a, jnp.zeros((1,) + a.shape[1:], a.dtype)], 0), jsp)
    jpad = jpad._replace(valid=jpad.valid.at[-1].set(False))
    jgeom, jfeat = jrp.pack_tile_inputs(jpad, jl)
    sp = as_port(jsp)
    lists, _ = rz.build_tile_lists(sp, 64, 64, 16, 128)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    np.testing.assert_array_equal(geom.numpy(), np.asarray(jgeom))
    np.testing.assert_array_equal(feat.numpy(), np.asarray(jfeat))
    dead = geom[lists == -1]
    assert dead.numel() and float(dead.abs().max()) == 0.0


FRAME = dict(tile=16, max_per_tile=128, chunk=64)
# name: (JAX function and its extra arguments, the port's and its)
LIST_ENTRY_POINTS = {
    "K3": (jrp.rasterize_tiled_pallas, {}, rz.rasterize_tiled_v1, {}),
    "K3-aux": (jrp.rasterize_tiled_pallas, {"with_aux": True},
               rz.rasterize_tiled_v1, {"with_aux": True}),
    "K4": (jrp.rasterize_tiled_pallas_grouped, {"group": 2},
           rz.rasterize_tiled_v2, {"group": 2}),
    "K5": (jrp.rasterize_tiled_pallas_v3, {"group": 2},
           rz.rasterize_tiled_v3, {"group": 2}),
}


@pytest.mark.parametrize("name", LIST_ENTRY_POINTS)
def test_list_entry_points_match_pallas_interpret(name):
    """`composite_lists_plain` behind each entry point against the Pallas
    kernel itself, every map (256 splats, 32², tile 16, max_per_tile 128,
    chunk 64)."""
    jfn, jkw, fn, kw = LIST_ENTRY_POINTS[name]
    g, cam = scene(0, 256, "sphere")
    ref = jfn(*jax_args(g, cam), 32, 32, **FRAME, **jkw)
    got = fn(*port_args(g, cam), 32, 32, **FRAME, **kw)
    assert_maps_close(got, ref)
    if name != "K3-aux":
        assert float(got["dist"].abs().max()) == 0.0


@pytest.mark.parametrize("name,group", [("K4", 8), ("K5", 4)])
def test_list_entry_points_tile_8(name, group):
    """8x8 tiles: 16 of them at 32², in groups."""
    jfn, _, fn, _ = LIST_ENTRY_POINTS[name]
    g, cam = scene(0, 256, "sphere")
    frame = dict(tile=8, max_per_tile=128, chunk=64, group=group)
    ref = jfn(*jax_args(g, cam), 32, 32, **frame)
    got = fn(*port_args(g, cam), 32, 32, **frame)
    assert_maps_close(got, ref)


def test_v1_aux_dist_matches_pallas_interpret():
    """dist from the prefix forms, on translucent shells seen from close
    range where it stands above its fp32 floor: 2e-2 of its peak."""
    g, cam = scene(0, 2048, "sphere", radius=0.6, opacity=0.2)
    frame = dict(tile=16, max_per_tile=256, chunk=64, with_aux=True)
    ref = jrp.rasterize_tiled_pallas(*jax_args(g, cam), 64, 64, **frame)
    got = rz.rasterize_tiled_v1(*port_args(g, cam), 64, 64, **frame)
    assert_maps_close(got, ref)
    ref_d = to_channel_first(ref["dist"])
    peak = float(np.abs(ref_d).max())
    assert peak >= DIST_FLOOR, f"dist peaks at {peak}, under {DIST_FLOOR}"
    err = float(np.abs(got["dist"].numpy() - ref_d).max())
    assert err <= DIST_REL * peak, f"dist error {err} of peak {peak}"


def test_v1_unflushed_transmittance_shows_in_the_image_only():
    """v1 keeps T <= 1e-4 where the v4 route flushes it: against
    `rasterize_tiled` the image differs by up to that much, nothing else
    does beyond the compositor tolerance."""
    g, cam = scene(0, 256, "sphere")
    v1 = rz.rasterize_tiled_v1(*port_args(g, cam), 32, 32, **FRAME)
    v4 = rz.rasterize_tiled(*port_args(g, cam), 32, 32, **FRAME)
    for k in v4:
        if k not in ("image", "dist"):
            torch.testing.assert_close(v1[k], v4[k], **TOL)
    residue = float((v1["image"] - v4["image"]).abs().max())
    assert 2e-5 < residue <= 1.1e-4


@pytest.mark.parametrize("fn,kw", [
    (rz.rasterize_tiled_v1, dict(with_aux=True)),
    (rz.rasterize_tiled_v2, dict(group=2)),
    (rz.rasterize_tiled_v3, dict(group=2)),
    (rz.rasterize_tiled_v4_dma, {})], ids=["v1", "v2", "v3", "v4_dma"])
def test_row_bands_tile_the_full_image(fn, kw):
    """`row0`/`full_h`: two 32-row bands are the halves of the 64-row
    render."""
    g, cam = scene(3, 512, None)
    frame = dict(tile=16, max_per_tile=128, chunk=64, **kw)
    full = fn(*port_args(g, cam), 64, 64, **frame)
    bands = [fn(*port_args(g, cam), 32, 64, full_h=64, row0=r, **frame)
             for r in (0, 32)]
    for k in full:
        torch.testing.assert_close(torch.cat([b[k] for b in bands], dim=1),
                                   full[k], atol=1e-5, rtol=0)


def test_v4_dma_matches_pallas_interpret():
    g, cam = scene(0, 512, "sphere")
    ref = jrp.rasterize_tiled_v4_dma(
        *jax_args(g, cam), 64, 64, tile=16, max_per_tile=256, chunk=64,
        group=4, steps_per_group=4.0)
    got = rz.rasterize_tiled_v4_dma(*port_args(g, cam), 64, 64, tile=16,
                                    max_per_tile=256, chunk=64)
    assert_maps_close(got, ref)


def test_v4_dma_has_no_dead_steps():
    """At (256 splats, 32², chunk 64, group 2, steps_per_group 4.0) the JAX
    DMA kernel composites a chunk twice (its dead steps are parked on the
    last group's last chunk, `rasterize_pallas.py:1204`) and is off by 0.4
    in alpha; the v4 kernel is right there, and the port, which has no
    step budget, agrees with it."""
    g, cam = scene(0, 256, "sphere")
    frame = dict(tile=16, max_per_tile=128, chunk=64)
    ref = jrp.rasterize_tiled_v4(*jax_args(g, cam), 32, 32, group=2,
                                 steps_per_group=4.0, **frame)
    got = rz.rasterize_tiled_v4_dma(*port_args(g, cam), 32, 32, **frame)
    assert_maps_close(got, ref)
    same = rz.rasterize_tiled(*port_args(g, cam), 32, 32, **frame)
    for k in same:
        torch.testing.assert_close(got[k], same[k], atol=0, rtol=0)


def test_v1_fused_gradient_matches_jax():
    """Gradient of the loss of `tests/test_pallas_kernel.py:47-63` with
    respect to the surfels: the JAX function differentiates its XLA path,
    the port its plain pair."""
    g, cam = scene(0, 128, "sphere")

    def jloss(gg):
        out = jrp.rasterize_tiled_fused(
            gg, cam["cam_view"], cam["cam_view_proj"], cam["tanfov"],
            jnp.ones(3), 32, 32, tile=16, max_per_tile=128, chunk=64,
            tile_group=4)
        return jnp.sum(out["image"] ** 2) + jnp.sum(out["alpha"])

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(g)))
    gg = t(g).requires_grad_(True)
    out = rz.rasterize_tiled_v1_fused(gg, *port_args(g, cam)[1:], 32, 32,
                                      tile=16, max_per_tile=128, chunk=64)
    ((out["image"] ** 2).sum() + out["alpha"].sum()).backward()
    assert float(gg.grad.abs().max()) > 0
    np.testing.assert_allclose(gg.grad.numpy(), ref, rtol=1e-3, atol=1e-4)
    # the forward is the v1 kernel's function with the distortion
    v1 = rz.rasterize_tiled_v1(*port_args(g, cam), 32, 32, tile=16,
                               max_per_tile=128, chunk=64, with_aux=True)
    for k in v1:
        torch.testing.assert_close(out[k].detach(), v1[k], atol=0, rtol=0)


def test_list_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers compute the plain versions and count no
    launch."""
    g, cam = scene(0, 256, "sphere")
    sp = rz.preprocess_splats(*port_args(g, cam)[:3], 32, 32)
    lists, counts = rz.build_tile_lists(sp, 32, 32, 16, 128)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    px, py = rz.tile_pixel_tables(torch.arange(4), 2, 16)
    ref = rz.composite_lists_plain(geom, feat, counts, px, py, 64)
    wrappers = (rasterize_cuda.composite_lists,
                rasterize_cuda.composite_lists_unrolled,
                rasterize_cuda.composite_lists_grouped,
                rasterize_cuda.composite_segments)
    before = [w.launches for w in wrappers]
    torch.testing.assert_close(rasterize_cuda.composite_lists(
        geom, feat, counts, 2, 16, 64), ref, atol=0, rtol=0)
    torch.testing.assert_close(rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, 2, 16, 64, 2), ref, atol=0, rtol=0)
    torch.testing.assert_close(rasterize_cuda.composite_lists_grouped(
        counts.reshape(2, 2).amax(1).int(), geom, feat, px, py,
        counts.float()[:, None], 2, 64), ref, atol=0, rtol=0)
    pairs, starts, cnt = rz.build_tile_pairs(sp, 32, 32, 16, 128)
    tab = rz.splat_table(sp, 32, 32)
    seg = rz.segment_table(tab, pairs)
    assert seg.shape == (pairs.shape[0], rz.TABLE_W)
    torch.testing.assert_close(
        rasterize_cuda.composite_segments(seg, starts, cnt, torch.ones(3),
                                          32, 32, chunk=64),
        rz.composite_plain(tab, pairs, starts, cnt, torch.ones(3), 32, 32,
                           chunk=64), atol=0, rtol=0)
    assert [w.launches for w in wrappers] == before


# the stage tools' sizes, set small on their modules' constants
STAGE_SIZES = dict(G=2, P=64, CHUNK=32, NC=3, NG=2)


def _pallas_stage(mod, stage, field_major, gmax, geom, feat, px, py):
    """`make_kernel(stage)` of a stage tool through `pl.pallas_call` in
    interpret mode, with the tool's own grid and block specs
    (`compile_stage`) on the given inputs."""
    G, P, CHUNK, NC, NG = (getattr(mod, k) for k in ("G", "P", "CHUNK", "NC",
                                                     "NG"))
    T = NG * G
    if field_major:
        in_specs = [pl.BlockSpec((16, G, CHUNK), lambda g, c, s: (0, g, c)),
                    pl.BlockSpec((8, G, CHUNK), lambda g, c, s: (0, g, c)),
                    pl.BlockSpec((1, G, P), lambda g, c, s: (0, g, 0)),
                    pl.BlockSpec((1, G, P), lambda g, c, s: (0, g, 0))]
        out_spec = pl.BlockSpec((16, G, P), lambda g, c, s: (0, g, 0))
        state, out_shape = (16, G, P), (16, T, P)
    else:
        in_specs = [pl.BlockSpec((G, CHUNK, 16), lambda g, c, s: (g, c, 0)),
                    pl.BlockSpec((G, CHUNK, 8), lambda g, c, s: (g, c, 0)),
                    pl.BlockSpec((G, P), lambda g, c, s: (g, 0)),
                    pl.BlockSpec((G, P), lambda g, c, s: (g, 0))]
        out_spec = pl.BlockSpec((G, P, 16), lambda g, c, s: (g, 0, 0))
        state, out_shape = (G, P, 16), (T, P, 16)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(NG, NC), in_specs=in_specs,
        out_specs=out_spec,
        scratch_shapes=[pltpu.VMEM(state, jnp.float32)])
    return pl.pallas_call(
        mod.make_kernel(stage), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(*(jnp.asarray(x.numpy()) for x in
                          (gmax, geom, feat, px, py)))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("field_major", [False, True],
                         ids=["row-major", "field-major"])
def test_stage_plain_matches_pallas_interpret(stage, field_major,
                                              monkeypatch):
    mod = bisect_field if field_major else bisect_row
    for k, v in STAGE_SIZES.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(mod, "T", STAGE_SIZES["NG"] * STAGE_SIZES["G"])
    s = STAGE_SIZES
    gmax, *row = kernel_stages.make_inputs(
        3, "cpu", s["G"], s["P"], s["CHUNK"], s["NC"], s["NG"])
    assert int(gmax.min()) < s["NC"] * s["CHUNK"]   # a group stops early
    args = kernel_stages.to_field_major(*row) if field_major else row
    ref = np.asarray(_pallas_stage(mod, stage, field_major, gmax, *args))
    got = rasterize_cuda.stage(stage, gmax, *args, s["G"], s["CHUNK"],
                               field_major=field_major).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)
    live = got[1] if field_major else got[..., 1]
    assert float(np.abs(live).max()) > 0
    if stage >= 2:      # the transmittance moved
        trans = got[0] if field_major else got[..., 0]
        assert float(trans.min()) < 0.5
