"""The kernels' warp cull is exact (plain PyTorch, no card).

K1, K2a, K2b and K6 skip a splat row for a whole warp when the warp's 8 × 4
pixel rectangle, widened by 1 px, misses the pixel box that `splat_table`
packs into the row's two padding columns (`csrc/composite_v4.cuh`). That
changes nothing only if no step the walk keeps lies outside: here every
(pixel, pair) step of a frame whose alpha passes the keep test
(alpha >= 1/255 and depth > 0.2, the plain walk's expressions in its order,
which the kernels share bit for bit) is checked against the box, on the
trainer's sphere, the translucent close-range "dist scene" and an
adversarial set of surfels.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.render import cameras

torch.set_num_threads(2)

WARP_W, WARP_H = rz.WARP_W, rz.WARP_H   # composite_v4.cuh: kWarpW, kWarpH
MARGIN = 1                  # pixels the warp's rectangle is widened by
TILE = 16


def unpack_box(tab):
    """(x0, x1, y0, y1) int32 of the box columns."""
    bits = tab[:, rz.PACKED_F:].contiguous().view(torch.int32)
    return (bits[:, 0] & 0xFFFF, bits[:, 0] >> 16, bits[:, 1] & 0xFFFF,
            bits[:, 1] >> 16)


def _keep(px, py, d):
    """The plain walk's keep test (`rasterize.composite_chunk`, the same
    expressions in the same order) for pixels (B, P) against rows d
    (B, 1, PACKED_F)."""
    p0 = px * d[..., 0] + py * d[..., 3] + d[..., 6]
    p1 = px * d[..., 1] + py * d[..., 4] + d[..., 7]
    p2 = px * d[..., 2] + py * d[..., 5] + d[..., 8]
    safe = torch.where(p2.abs() < 1e-9, torch.full_like(p2, 1e-9), p2)
    inv = 1.0 / safe
    u = p0 * inv
    v = p1 * inv
    rho3d = u * u + v * v
    dx = px - d[..., 12]
    dy = py - d[..., 13]
    rho2d = rz.FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, u * d[..., 9] + v * d[..., 10] + d[..., 11],
                        d[..., 14].expand_as(u))
    g = torch.exp(-0.5 * rho) * torch.clamp((rz.RHO_CUT - rho) / rz.RHO_RAMP,
                                            0.0, 1.0)
    alpha = torch.clamp(d[..., 15] * g, max=rz.ALPHA_MAX)
    return (alpha >= rz.ALPHA_EPS) & (depth > rz.NEAR_CULL)


def cull_census(tab, pairs, starts, counts, img_w, batch=4096, row0=0,
                rect_row0=None):
    """(kept steps outside their warp's widened rectangle ∩ box, kept
    steps, steps the cull skips) over every (pixel, pair) step of every
    tile's segment. `row0`: the frame is a band whose first row is image
    row row0 (the pixels' rays and the boxes in image rows); `rect_row0`
    (default row0) places the warps' rectangles, so a census with 0 there
    is that of a cull in band-local rows."""
    rect_row0 = row0 if rect_row0 is None else rect_row0
    tiles_x = img_w // TILE
    lidx = torch.arange(TILE * TILE)
    lx, ly = lidx % TILE, lidx // TILE
    wx, wy = lx // WARP_W * WARP_W, ly // WARP_H * WARP_H
    live = [(t, int(s), int(c)) for t, (s, c) in
            enumerate(zip(starts.tolist(), counts.tolist())) if c]
    tile_of = torch.cat([torch.full((c,), t) for t, _, c in live])
    pos = torch.cat([torch.arange(s, s + c) for _, s, c in live])
    x0, x1, y0, y1 = unpack_box(tab)
    bad = kept = skipped = 0
    for b0 in range(0, len(pos), batch):
        t = tile_of[b0:b0 + batch]
        ids = pairs[pos[b0:b0 + batch]].long()
        ox = (t % tiles_x * TILE)[:, None]
        oy = (t // tiles_x * TILE)[:, None] + row0
        keep = _keep((ox + lx).float(), (oy + ly).float(),
                     tab[ids, None, :rz.PACKED_F])
        oy = oy - row0 + rect_row0
        hit = ((x1[ids][:, None] >= ox + wx - MARGIN)
               & (x0[ids][:, None] <= ox + wx + WARP_W - 1 + MARGIN)
               & (y1[ids][:, None] >= oy + wy - MARGIN)
               & (y0[ids][:, None] <= oy + wy + WARP_H - 1 + MARGIN))
        bad += int((keep & ~hit).sum())
        kept += int(keep.sum())
        skipped += int((~hit).sum())
    return bad, kept, skipped, len(pos) * TILE * TILE


def _frame(g, pose, radius, res, mpt):
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [pose])[0])
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"], res,
                              res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, TILE, mpt)
    return sp, rz.splat_table(sp, res, res), pairs, starts, counts


def _quat_to(n, phi):
    """Quaternions (w, x, y, z) turning +z onto the unit normals n, then
    spinning the disk by phi about its normal."""
    q = np.concatenate([(1 + n[:, 2])[:, None], -n[:, 1:2], n[:, 0:1],
                        np.zeros((len(n), 1))], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c, s = np.cos(phi / 2), np.sin(phi / 2)
    w, x, y, z = q.T
    return np.stack([w * c - z * s, x * c + y * s, y * c - x * s,
                     z * c + w * s], 1)


def adversarial_surfels(seed, n=3000, radius=1.8, pose=(20, 45)):
    """Near-grazing tilted surfels, surfels larger than a tile, surfels just
    beyond the 0.2 near plane and sub-pixel surfels, mixed, in the view of
    `generate_input_camera(radius, [pose])`."""
    rng = np.random.default_rng(seed)
    c2w = cameras.generate_input_camera(radius, [pose])[0][:16].reshape(4, 4)
    eye = c2w[:3, 3].astype(np.float64)
    fwd = -eye / np.linalg.norm(eye)
    side = np.cross(fwd, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side)
    up = np.cross(side, fwd)
    kind = rng.integers(0, 4, n)
    # view directions inside the 30° field, depths by kind
    ang = rng.uniform(-0.25, 0.25, (n, 2))
    ray = fwd + ang[:, :1] * side + ang[:, 1:] * up
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    depth = np.where(kind == 2, rng.uniform(0.19, 0.4, n),
                     rng.uniform(1.2, 2.4, n))
    xyz = eye + ray * depth[:, None]
    # normals: grazing (within a few degrees of the ray's normal plane) for
    # kind 0, any orientation otherwise
    rnd = rng.normal(size=(n, 3))
    perp = rnd - (rnd * ray).sum(1, keepdims=True) * ray
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    tilt = np.radians(rng.uniform(0.05, 6.0, n))[:, None]
    graze = np.cos(tilt) * perp + np.sin(tilt) * ray
    free = rnd / np.linalg.norm(rnd, axis=1, keepdims=True)
    nrm = np.where((kind == 0)[:, None], graze, free)
    scale = np.exp(rng.uniform(np.log(2e-3), np.log(3e-2), (n, 2)))
    scale[kind == 1] = rng.uniform(0.05, 0.25, (int((kind == 1).sum()), 2))
    scale[kind == 2] *= 0.2
    scale[kind == 3] = rng.uniform(1e-5, 4e-4, (int((kind == 3).sum()), 2))
    rot = _quat_to(nrm, rng.uniform(0, 2 * np.pi, n))
    opacity = rng.uniform(0.3, 1.0, (n, 1))
    rgb = rng.uniform(0, 1, (n, 3))
    g = np.concatenate([xyz, opacity, scale, rot, rgb], 1)
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("n,res", [(768, 128), (6144, 256)])
def test_cull_keeps_every_kept_step_of_the_train_sphere(n, res):
    _, tab, pairs, starts, counts = _frame(
        make_object(0, n=n, kind="sphere"), (20, 45), 1.8, res, 1024)
    bad, kept, skipped, steps = cull_census(tab, pairs, starts, counts, res)
    assert kept > 0 and bad == 0
    # the cull has work to do: a large share of the steps lie outside
    assert skipped > 0.2 * steps, skipped / steps


def test_cull_keeps_every_kept_step_of_the_dist_scene():
    g = make_object(0, n=73728, kind="sphere")
    g[:, 3] = 0.2
    _, tab, pairs, starts, counts = _frame(g, (20, 45), 0.6, 512, 1024)
    bad, kept, skipped, steps = cull_census(tab, pairs, starts, counts, 512)
    assert kept > 0 and bad == 0 and skipped > 0


@pytest.mark.parametrize("seed,pose", [(0, (20, 45)), (1, (-35, 200)),
                                       (2, (60, 10))])
def test_cull_keeps_every_kept_step_of_adversarial_surfels(seed, pose):
    """Near-grazing, larger than a tile, at the near plane, sub-pixel."""
    sp, tab, pairs, starts, counts = _frame(
        adversarial_surfels(seed, pose=pose), pose, 1.8, 256, 4096)
    bad, kept, skipped, steps = cull_census(tab, pairs, starts, counts, 256)
    assert kept > 0 and bad == 0 and skipped > 0
    # each kind is on screen and binned
    assert int(sp.valid.sum()) > 1000 and int(counts.max()) > 100


@pytest.mark.parametrize("res", [64, 256])
def test_splat_table_box_columns_unpack_to_the_screen_box(res):
    g = torch.cat([make_object(3, n=2048), adversarial_surfels(4)])
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0])
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    tab = rz.splat_table(sp, res, res)
    x0, x1, y0, y1 = unpack_box(tab)
    ok = sp.valid
    for got, ref, size in ((x0, torch.floor(sp.bb_min[:, 0]), res),
                           (x1, torch.ceil(sp.bb_max[:, 0]), res),
                           (y0, torch.floor(sp.bb_min[:, 1]), res),
                           (y1, torch.ceil(sp.bb_max[:, 1]), res)):
        want = torch.clamp(ref, 0, size - 1).int()
        assert torch.equal(got[ok], want[ok])
        assert ((got >= 0) & (got < size)).all()
    # splats cut by the image's edge are clamped to it
    assert bool(((sp.bb_min[ok] < 0) | (sp.bb_max[ok] > res - 1)).any())
    # the packed fields are `pack_splat_render`'s, and only they carry a
    # gradient
    torch.testing.assert_close(tab[:, :rz.PACKED_F],
                               rz.pack_splat_render(sp).t(), rtol=0, atol=0)
    gg = g.clone().requires_grad_(True)
    sp = rz.preprocess_splats(gg, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    tab = rz.splat_table(sp, res, res)
    assert tab.requires_grad
    (tab[:, rz.PACKED_F:] * 0 + tab[:, :2]).sum().backward()
    assert gg.grad is not None


def _band_frames(g, pose, radius, res, mpt, n_bands):
    """The bands of one view as `render/sharded.py` renders them: the
    splats projected and their table built against the whole image, each
    band binned with its row0."""
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [pose])[0])
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"], res,
                              res)
    tab = rz.splat_table(sp, res, res)
    band = res // n_bands
    for i in range(n_bands):
        yield i * band, tab, rz.build_tile_pairs(sp, band, res, TILE, mpt,
                                                 row0=i * band)


@pytest.mark.parametrize("scene,n_bands", [("sphere", 2), ("sphere", 4),
                                           ("adversarial", 4)])
def test_cull_keeps_every_kept_step_of_each_band(scene, n_bands):
    """The census of each band with its nonzero row0: the kernels place a
    band's warp rectangles in image rows (`pixel_slot(lid, tx0, ty0 +
    row0)`), where the boxes are. Placed in band-local rows instead, the
    same census finds kept steps the cull would drop in every band below
    the first: a wrong cull crashes nothing, so the census must see it."""
    pose = (20, 45)
    g = make_object(0, n=6144, kind="sphere") if scene == "sphere" \
        else adversarial_surfels(0, pose=pose)
    local_bad = 0
    for row0, tab, (pairs, starts, counts) in _band_frames(
            g, pose, 1.8, 256, 4096, n_bands):
        bad, kept, skipped, _ = cull_census(tab, pairs, starts, counts, 256,
                                            row0=row0)
        assert kept > 0 and bad == 0 and skipped > 0, row0
        if row0:
            local_bad += cull_census(tab, pairs, starts, counts, 256,
                                     row0=row0, rect_row0=0)[0]
    assert local_bad > 0
