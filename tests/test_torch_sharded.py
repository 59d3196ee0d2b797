"""Row-band rendering (`rasterize_tiled(..., full_h, row0)`,
`render/sharded.render_view_sharded`) against the JAX package's
`render_view_sharded` on the 8-device CPU mesh of tests/conftest.py.

A 64² view in 4 bands of 16 rows (mesh data 2 × tile 4) of the big-splat
scene, whose splats cross the band edges. Each band through the plain
compositor, and the joined bands, against JAX's full maps: atol 2e-5 /
rtol 1e-4; the gradient of Σ maps · N(0, 1) weights summed over the bands
against JAX's (the splat cotangents psum-ed over `tile`): rtol 2e-3 / atol
2e-4 of the gradient's size, the port's rasterizer tolerances
(tests/test_torch_rasterize.py, tests/test_torch_rasterize_grad.py). A
gloo run of the port's `render_view_sharded` on two ranks equals the bands
rendered in one process bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.parallel.mesh import make_mesh as jmake_mesh
from gaussiananything_tpu.render.sharded import \
    render_view_sharded as jrender_view_sharded
from gaussiananything_tpu_torch.ops import rasterize as rz
from test_torch_rasterize import TOL, scene, t, to_channel_first
from test_torch_rasterize_grad import MAPS, _weights

import torch_dist_workers as workers

torch.set_num_threads(2)

RES, N_TILE, MPT, CHUNK = 64, 4, 256, 64
BAND = RES // N_TILE


@pytest.fixture(scope="module")
def case():
    g, cam = scene(3, 1024, None)
    return g, cam["cam_view"][0], cam["cam_view_proj"][0], \
        cam["tanfov"][0], _weights(7, RES)


def _port_weights(wts):
    return {k: t(np.moveaxis(wts[k].reshape(RES, RES, -1), -1, 0))
            for k in MAPS}


def _bands(g, cv, cvp, grad_wts=None, n_tile=N_TILE):
    """The port's bands (plain compositor) and, with `grad_wts`, the
    gradient of Σ maps · weights summed over the bands."""
    gg = t(g).requires_grad_(grad_wts is not None)
    band = RES // n_tile
    bands = [rz.rasterize_tiled(gg, t(cv), t(cvp), torch.ones(3), band, RES,
                                max_per_tile=MPT, chunk=CHUNK, impl="plain",
                                full_h=RES, row0=i * band)
             for i in range(n_tile)]
    if grad_wts is None:
        return bands, None
    loss = sum((b[k] * grad_wts[k][:, i * band:(i + 1) * band]).sum()
               for i, b in enumerate(bands) for k in MAPS)
    loss.backward()
    return bands, gg.grad


@pytest.fixture(scope="module")
def jax_sharded(case):
    g, cv, cvp, tf, wts = case
    mesh = jmake_mesh(data=2, tile=N_TILE, devices=jax.devices()[:8])

    def render(gg):
        return jrender_view_sharded(mesh, gg, cv, cvp, tf, jnp.ones(3), RES,
                                    max_per_tile=MPT, chunk=CHUNK)

    @jax.jit
    def maps_and_grad(gg, w):
        # one compile for both: the maps and their pullback of the weights
        out, pull = jax.vjp(render, gg)
        return out, pull({k: w[k].reshape(out[k].shape) for k in out})[0]

    out, grad = maps_and_grad(jnp.asarray(g),
                              {k: jnp.asarray(v) for k, v in wts.items()})
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(grad)


def test_each_band_matches_jax(case, jax_sharded):
    g, cv, cvp, _, _ = case
    ref, _ = jax_sharded
    bands, _ = _bands(g, cv, cvp)
    for i, b in enumerate(bands):
        for k in MAPS:
            np.testing.assert_allclose(
                b[k].numpy(),
                to_channel_first(ref[k])[:, i * BAND:(i + 1) * BAND],
                err_msg=f"band {i} {k}", **TOL)


def test_joined_bands_and_gradient_match_jax(case, jax_sharded):
    g, cv, cvp, _, wts = case
    ref, ref_grad = jax_sharded
    bands, grad = _bands(g, cv, cvp, _port_weights(wts))
    for k in MAPS:
        joined = torch.cat([b[k] for b in bands], dim=1)
        np.testing.assert_allclose(joined.detach().numpy(),
                                   to_channel_first(ref[k]), err_msg=k,
                                   **TOL)
    scale = max(1.0, float(np.abs(ref_grad).max()))
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=2e-3,
                               atol=2e-4 * scale)


def test_band_backward_matches_jax_composite(case):
    """`composite_plain_backward` with row0 against the cotangent JAX's
    `rasterize_tiled` gives the splat table through a band (its VJP with
    the same full_h/row0), on the same table and pair lists."""
    from gaussiananything_tpu.ops import rasterize as jrz
    g, cv, cvp, tf, wts = case
    i = 2
    row0 = i * BAND
    sp = rz.preprocess_splats(t(g), t(cv), t(cvp), RES, RES)
    pairs, starts, counts = rz.build_tile_pairs(sp, BAND, RES, 16, MPT,
                                                row0=row0)
    tab = rz.splat_table(sp, RES, RES)
    ct = torch.randn((rz.N_OUT, BAND, RES),
                     generator=torch.Generator().manual_seed(3))
    got = rz.composite_plain_backward(tab, pairs, starts, counts,
                                      torch.ones(3), ct, BAND, RES,
                                      chunk=CHUNK, row0=row0)

    # JAX: the same band's maps as a function of the surfels, through the
    # projection, against the port's: pull both back to the surfels
    def jmaps(gg):
        out = jrz.rasterize_tiled(gg, cv, cvp, tf, jnp.ones(3), BAND, RES,
                                  tile=16, max_per_tile=MPT, chunk=CHUNK,
                                  tile_group=4, full_h=RES, row0=row0)
        return jnp.concatenate([jnp.moveaxis(
            out[k].reshape(BAND, RES, -1), -1, 0) for k in MAPS])

    ref = np.asarray(jax.jit(lambda gg, c: jax.vjp(jmaps, gg)[1](c)[0])(
        jnp.asarray(g), jnp.asarray(ct.numpy())))
    gg = t(g).requires_grad_(True)
    sp = rz.preprocess_splats(gg, t(cv), t(cvp), RES, RES)
    tab_g = rz.splat_table(sp, RES, RES)
    mine, = torch.autograd.grad(tab_g, gg, got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=2e-3,
                               atol=2e-4 * scale)


def test_two_gloo_ranks_equal_in_process_bands(case, tmp_path):
    g, cv, cvp, _, wts = case
    pw = _port_weights(wts)
    inputs, out = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save({"g": t(g), "cv": t(cv), "cvp": t(cvp), "res": RES,
                "mpt": MPT, "chunk": CHUNK, "wts": pw}, inputs)
    workers.run(workers.sharded_render, 2, str(inputs), str(out))
    got = torch.load(out)
    bands, grad = _bands(g, cv, cvp, pw, n_tile=2)
    for k in MAPS:
        assert torch.equal(got["maps"][k],
                           torch.cat([b[k] for b in bands], 1).detach()), k
    assert torch.equal(got["grad"], grad)
