"""K4's group test split over thread-block clusters, and the parts of the K4
and K5 wrappers that run without a card.

On the card K4 runs a count-sorted group as a cluster of at most 16 blocks;
a larger group runs its saturation test per cluster. The plain twin of that
walk, built here from `rasterize.composite_lists_plain` itself, must give
that function's maps bit for bit on scenes where the test does skip. The
JAX counterparts of K4 and K5 in interpret mode are held against the port
in `tests/test_torch_raster_variants.py`."""
from __future__ import annotations

import pytest
import torch

from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.ops import rasterize_cuda
from gaussiananything_tpu_torch.render import cameras

torch.set_num_threads(2)

# name: (splats, image size, tile, max_per_tile, chunk, opacity or None,
# camera radius). "small" is chip_smoke.py's small list case; the opaque
# scenes saturate whole tiles and clusters before their last chunk.
SCENES = {
    "small": (1024, 64, 16, 256, 64, None, 1.8),
    "opaque tile 16": (2048, 64, 16, 256, 32, 0.95, 1.0),
    "opaque tile 8": (4096, 64, 8, 256, 32, 0.95, 0.9),
}
# (group, cluster): clusters of 1, 2, 4 and 16 tiles, and G = 32 in two
# (the 64² scenes at tile 16 have 16 tiles, at tile 8 64)
SPLITS = [(16, 1), (16, 2), (16, 4), (16, 16)]
CASES = [(name, *split) for name in SCENES for split in SPLITS]
CASES.append(("opaque tile 8", 32, 16))


def _lists(name):
    """Dense lists of a scene in natural tile order, the tiles' pixel
    tables, chunk, tiles_x and tile."""
    n, res, tile, mpt, chunk, opacity, radius = SCENES[name]
    g = make_object(0, n=n, kind="sphere", device="cpu")
    if opacity is not None:
        g[:, 3] = opacity
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [(20, 45)])[0], device="cpu")
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"], res,
                              res)
    lists, counts = rz.build_tile_lists(sp, res, res, tile, mpt)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    px, py = rz.tile_pixel_tables(torch.arange(counts.shape[0]), res // tile,
                                  tile)
    return geom, feat, counts, px, py, chunk, res // tile, tile


def _sorted_lists(name):
    """The lists in `rasterize_tiled_v2`'s count-sorted order: geom, feat,
    counts, px, py, chunk."""
    geom, feat, counts, px, py, chunk, _, _ = _lists(name)
    order = torch.sort(-counts, stable=True).indices
    return geom[order], feat[order], counts[order], px[order], py[order], \
        chunk


def _trans_after(args):
    """T of every pixel after chunks 0 .. c - 1, for c = 0 .. M / chunk:
    `composite_lists_plain` with every count clamped at c·chunk (the chunks
    from c on then hold no row, and a chunk without rows changes no map)."""
    geom, feat, counts, px, py, chunk = args
    return [rz.composite_lists_plain(geom, feat,
                                     counts.clamp(max=c * chunk), px, py,
                                     chunk)[..., 10]
            for c in range(geom.shape[1] // chunk + 1)]


def _cluster_split(args, trans, group, cluster):
    """K4's walk with its group test per cluster, in plain PyTorch: a
    cluster of `cluster` consecutive tiles (of groups of `group`) stops at
    c_stop, the first chunk c with c·chunk >= its group's largest count or
    no pixel of the cluster above T_EPS in `trans[c]`; each tile's count is
    clamped at c_stop·chunk. Returns the maps of `composite_lists_plain` on
    the clamped counts and the number of tiles that lost rows."""
    geom, feat, counts, px, py, chunk = args
    gmax = counts.reshape(-1, group).amax(1).repeat_interleave(group)
    stop = torch.full_like(counts, len(trans) - 1)
    done = torch.zeros_like(counts, dtype=torch.bool)
    for c, t in enumerate(trans):
        live = (t > rz.T_EPS).any(1).reshape(-1, cluster).any(1)
        ends = ~done & ((c * chunk >= gmax)
                        | ~live.repeat_interleave(cluster))
        stop[ends] = c
        done |= ends
    clamped = torch.minimum(counts, stop * chunk)
    return (rz.composite_lists_plain(geom, feat, clamped, px, py, chunk),
            int((clamped < counts).sum()))


@pytest.fixture(scope="module")
def scenes():
    """Each scene's lists, the transmittance after each chunk, and the
    maps of `composite_lists_plain`."""
    out = {}
    for name in SCENES:
        args = _sorted_lists(name)
        out[name] = (args, _trans_after(args),
                     rz.composite_lists_plain(*args))
    return out


@pytest.mark.parametrize("name,group,cluster", CASES)
def test_cluster_split_group_test_changes_no_map(scenes, name, group,
                                                  cluster):
    args, trans, want = scenes[name]
    got, skipped = _cluster_split(args, trans, group, cluster)
    assert torch.equal(got, want)
    if name == "opaque tile 8" or (name != "small" and cluster == 1):
        assert skipped > 0      # the test did skip chunks with rows


def test_transmittance_reads_are_the_walks_states(scenes):
    """T read after c chunks never rises with c, starts at 1 and ends at the
    T of the whole walk: the states the twin's test reads."""
    for name, (args, trans, want) in scenes.items():
        assert torch.equal(trans[0], torch.ones_like(trans[0])), name
        for a, b in zip(trans, trans[1:]):
            assert bool((b <= a).all()), name
        assert torch.equal(trans[-1], want[..., 10]), name


@pytest.mark.parametrize("limit", [16, 8, 5, 1])
def test_cluster_size_is_the_largest_divisor_below_the_limit(limit):
    for group in range(1, 65):
        size = rasterize_cuda.cluster_size(group, limit)
        assert group % size == 0 and 1 <= size <= limit
        assert not any(group % d == 0 for d in range(size + 1, limit + 1))
        if group <= limit:
            assert size == group
    assert rasterize_cuda.cluster_size(32, 16) == 16
    assert rasterize_cuda.cluster_size(48, 16) == 16
    assert rasterize_cuda.cluster_size(17, 16) == 1
    assert rasterize_cuda.cluster_size(36, 16) == 12


def test_wrappers_refuse_a_group_that_does_not_divide_the_tiles():
    geom, feat, counts, px, py, chunk = _sorted_lists("small")  # 16 tiles
    gmax = counts[:1].int()
    with pytest.raises(ValueError, match="not a multiple of the group 3"):
        rasterize_cuda.composite_lists_grouped(
            gmax, geom, feat, px, py, counts.float()[:, None], 3, chunk)
    with pytest.raises(ValueError, match="not a multiple of the group 3"):
        rasterize_cuda.composite_lists_unrolled(geom, feat, counts, 4, 16,
                                                chunk, 3)
    with pytest.raises(ValueError, match="not a multiple of the group 0"):
        rasterize_cuda.composite_lists_unrolled(geom, feat, counts, 4, 16,
                                                chunk, 0)


@pytest.mark.parametrize("group", [1, 4, 16])
def test_wrappers_on_cpu_tensors_compute_the_plain_function(group):
    geom, feat, counts, px, py, chunk = _sorted_lists("small")
    want = rz.composite_lists_plain(geom, feat, counts, px, py, chunk)
    gmax = counts.reshape(-1, group).amax(1).int()
    got = rasterize_cuda.composite_lists_grouped(
        gmax, geom, feat, px, py, counts.float()[:, None], group, chunk)
    assert torch.equal(got, want)
    before = rasterize_cuda.composite_lists_unrolled.launches
    geom, feat, counts, px, py, chunk, tiles_x, tile = _lists("small")
    got = rasterize_cuda.composite_lists_unrolled(geom, feat, counts,
                                                  tiles_x, tile, chunk, group)
    assert rasterize_cuda.composite_lists_unrolled.launches == before
    assert torch.equal(got, rz.composite_lists_plain(geom, feat, counts, px,
                                                     py, chunk))
