"""The port's kernels on the card, against their plain versions on the same
card and inputs. Marked `cuda`: each skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import pytest
import torch

from gaussiananything_tpu_torch.ops import kernel_lib
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.ops import rasterize_cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA kernels")
    from gaussiananything_tpu_torch.utils.device import resolve_device
    # the card held against plain versions and the CPU: IEEE products
    return resolve_device("cuda", matmul_precision="highest")


@pytest.mark.cuda
@pytest.mark.parametrize("res,n,chunk", [(64, 1024, 64), (512, 73728, 256)])
def test_k1_matches_plain(card, res, n, chunk):
    """Compositor tolerance of `test_torch_rasterize.py` (atol 2e-5 / rtol
    1e-4): the same per-pair expressions, sums in another order."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(0, n=n, kind="sphere", device=card)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=card)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, 2048)
    tab = rz.splat_table(sp, res, res)
    bg = torch.ones(3, device=card)
    before = rasterize_cuda.composite.launches
    got = rasterize_cuda.composite(tab, pairs, starts, counts, bg, res, res,
                                   chunk=chunk)
    torch.cuda.synchronize()
    assert rasterize_cuda.composite.launches == before + 1
    ref = rz.composite_plain(tab, pairs, starts, counts, bg, res, res,
                             chunk=chunk)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_k1_dist_matches_plain(card):
    """dist on translucent shells seen from close range, where it peaks at
    ~2e-4 (on the scenes above it is ~1e-7, under its fp32 floor), over
    chunks of 32 so that the entry-state cross terms carry it: held to 2e-2
    of its largest value, and every other channel to the compositor
    tolerance."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(0, n=73728, kind="sphere", device=card)
    g[:, 3] = 0.2
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(0.6, [(20, 45)])[0], device=card)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              512, 512)
    pairs, starts, counts = rz.build_tile_pairs(sp, 512, 512, 16, 2048)
    tab = rz.splat_table(sp, 512, 512)
    bg = torch.ones(3, device=card)
    got = rz.split_outputs(rasterize_cuda.composite(
        tab, pairs, starts, counts, bg, 512, 512, chunk=32))
    ref = rz.split_outputs(rz.composite_plain(
        tab, pairs, starts, counts, bg, 512, 512, chunk=32))
    peak = float(ref["dist"].abs().max())
    assert peak >= 1e-4
    assert float((got["dist"] - ref["dist"]).abs().max()) <= 2e-2 * peak
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_k1_wrapper_refuses_bad_inputs(card):
    tab = torch.zeros((4, rz.TABLE_W), device=card)
    pairs = torch.zeros(8, dtype=torch.int32, device=card)
    starts = torch.zeros(4, dtype=torch.int32, device=card)
    bg = torch.ones(3, device=card)
    with pytest.raises(ValueError, match="int32"):
        rasterize_cuda.composite(tab, pairs, starts.long(), starts, bg,
                                 32, 32)
    with pytest.raises(ValueError, match="16x16"):
        rasterize_cuda.composite(tab, pairs, starts, starts, bg, 32, 32,
                                 tile=8)
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_cuda.composite(tab, pairs, starts, starts, bg.cpu(),
                                 32, 32)


def _frame(card, n, res, mpt, opacity=None, radius=1.8):
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(0, n=n, kind="sphere", device=card)
    if opacity is not None:
        g[:, 3] = opacity
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [(20, 45)])[0], device=card)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, mpt)
    tab = rz.splat_table(sp, res, res)
    return (tab, pairs, starts, counts, torch.ones(3, device=card), res, res)


# (splats, image size, chunk, opacity, camera radius): the trainer's two
# extreme shapes and the translucent close-range scene
K2_CASES = [(6144, 256, 128, None, 1.8), (73728, 512, 128, None, 1.8),
            (73728, 512, 32, 0.2, 0.6)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,res,chunk,opacity,radius", K2_CASES)
def test_k2a_matches_plain(card, n, res, chunk, opacity, radius):
    """K2a's buffer is K1's bit for bit; buffer, entry states, executed
    chunk counts and marks against `composite_plain(return_entries=True)`.
    The entries buffer is sized from shapes (`rz.max_entry_rows`); its
    first `chunk_off[-1]` rows are the plain version's, and the marks'
    equal them bit for bit."""
    args = _frame(card, n, res, 1024, opacity, radius)
    before = rasterize_cuda.composite_entries.launches
    buf, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
        *args, chunk=chunk)
    assert rasterize_cuda.composite_entries.launches == before + 1
    assert torch.equal(buf, rasterize_cuda.composite(*args, chunk=chunk))
    rbuf, rentries, rn_exec, rmarks = rz.composite_plain(
        *args, chunk=chunk, return_entries=True)
    assert torch.equal(n_exec, rn_exec)
    assert torch.equal(marks[:rmarks.shape[0]], rmarks)
    assert entries.shape[0] == rz.max_entry_rows(args[1].shape[0],
                                                 (res // 16) ** 2, chunk)
    assert int(off[-1]) == rentries.shape[0] <= entries.shape[0]
    torch.testing.assert_close(buf, rbuf, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(entries[:rentries.shape[0]], rentries,
                               atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,res,chunk,opacity,radius", K2_CASES)
def test_k2b_matches_plain_and_is_deterministic(card, n, res, chunk, opacity,
                                                radius):
    """The table cotangent under a random cotangent on all ten channels,
    dist's at the trainer's weight 100: per field within 2e-3 of the
    field's largest value; two runs bit-equal (no float atomics)."""
    tab, pairs, starts, counts, bg, _, _ = args = _frame(
        card, n, res, 1024, opacity, radius)
    ct = torch.randn((rz.N_OUT, res, res),
                     generator=torch.Generator().manual_seed(1)).to(card)
    ct[6] *= 100.0
    _, *state = rasterize_cuda.composite_entries(*args, chunk=chunk)
    order, seg = rasterize_cuda.splat_order(pairs, starts, counts,
                                            tab.shape[0])
    before = rasterize_cuda.composite_backward.launches
    runs = [rasterize_cuda.composite_backward(
        tab, pairs, starts, counts, bg, ct, *state, order, seg, res, res,
        chunk=chunk) for _ in range(2)]
    assert rasterize_cuda.composite_backward.launches == before + 2
    assert torch.equal(*runs)
    ref = rz.composite_plain_backward(tab, pairs, starts, counts, bg, ct,
                                      res, res, chunk=chunk)
    err = (runs[0] - ref).abs().amax(0)
    peak = ref.abs().amax(0)
    assert torch.isfinite(runs[0]).all()
    assert (err <= 2e-3 * peak + 1e-12).all(), (err / peak).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 48, 96])
def test_k2_pair_matches_plain_below_chunk_128(card, chunk):
    """Chunks below the trainer's 128 and off the 32-slot words of K2b's
    masks: K2a's buffer is K1's bit for bit and the plain version's to the
    compositor tolerance, K2b's table cotangent within 2e-3 of each field's
    largest value, dist at weight 100."""
    tab, pairs, starts, counts, bg, res, _ = args = _frame(card, 6144, 256,
                                                           1024)
    buf, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
        *args, chunk=chunk)
    assert torch.equal(buf, rasterize_cuda.composite(*args, chunk=chunk))
    rbuf, rentries, rn_exec, rmarks = rz.composite_plain(
        *args, chunk=chunk, return_entries=True)
    assert torch.equal(n_exec, rn_exec)
    assert torch.equal(marks[:rmarks.shape[0]], rmarks)
    torch.testing.assert_close(buf, rbuf, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(entries[:rentries.shape[0]], rentries,
                               atol=2e-5, rtol=1e-4)
    ct = torch.randn((rz.N_OUT, res, res),
                     generator=torch.Generator().manual_seed(3)).to(card)
    ct[6] *= 100.0
    order, seg = rasterize_cuda.splat_order(pairs, starts, counts,
                                            tab.shape[0])
    got = rasterize_cuda.composite_backward(
        tab, pairs, starts, counts, bg, ct, off, entries, n_exec, marks,
        order, seg, res, res, chunk=chunk)
    ref = rz.composite_plain_backward(tab, pairs, starts, counts, bg, ct,
                                      res, res, chunk=chunk)
    err = (got - ref).abs().amax(0)
    peak = ref.abs().amax(0)
    assert (err <= 2e-3 * peak + 1e-12).all(), (err / peak).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [576, 1024])
def test_k2_tile_order_is_heaviest_first(card, n_tiles):
    """The order K2a and K2b take the tiles in (`ga_tile_order`, the kernel
    both launch first): the tiles by descending work, ties by id, as a
    stable sort gives it, the work being the counts or, with `n_exec`,
    min(counts, n_exec · chunk); and the chunk offsets of
    `rz.chunk_offsets`. On seeded counts with many ties."""
    gen = torch.Generator().manual_seed(n_tiles)
    counts = torch.randint(0, 40, (n_tiles,), generator=gen).mul(37).int()
    n_exec = torch.randint(0, 12, (n_tiles,), generator=gen).int()
    counts, n_exec = counts.to(card), n_exec.to(card)
    lib = rasterize_cuda.library("fwd")
    stream = torch.cuda.current_stream(card).cuda_stream
    order = torch.empty(n_tiles, dtype=torch.int32, device=card)
    off = torch.empty(n_tiles + 1, dtype=torch.int32, device=card)
    assert lib.ga_tile_order(counts.data_ptr(), None, 128, n_tiles,
                             order.data_ptr(), off.data_ptr(), stream) == 0
    assert torch.equal(order, torch.sort(counts, descending=True,
                                         stable=True).indices.int())
    assert torch.equal(off, rz.chunk_offsets(counts, 128))
    assert lib.ga_tile_order(counts.data_ptr(), n_exec.data_ptr(), 128,
                             n_tiles, order.data_ptr(), None, stream) == 0
    work = torch.minimum(counts, n_exec * 128)
    assert torch.equal(order, torch.sort(work, descending=True,
                                         stable=True).indices.int())


@pytest.mark.cuda
def test_k2a_writes_the_chunk_offsets_and_every_tile(card):
    """K2a's wrapper leaves `chunk_off` and `n_exec` to the kernel: they
    are `rz.chunk_offsets` and the plain version's, every tile ran (its
    buffer is K1's, in raster order, bit for bit), and the entries and
    marks past each tile's executed chunks up to its ceil(count / chunk)
    are zero."""
    args = _frame(card, 24576, 384, 1024)
    counts = args[3]
    buf, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
        *args, chunk=128)
    assert torch.equal(off, rz.chunk_offsets(counts, 128))
    assert torch.equal(buf, rasterize_cuda.composite(*args, chunk=128))
    _, rentries, rn_exec, _ = rz.composite_plain(*args, chunk=128,
                                                 return_entries=True)
    assert torch.equal(n_exec, rn_exec)
    skipped = rentries.abs().sum((1, 2)) == 0
    assert bool(skipped.any())
    assert (entries[:rentries.shape[0]][skipped] == 0).all()
    assert (marks[:rentries.shape[0]][skipped] == 0).all()


@pytest.mark.cuda
def test_training_function_gradient_matches_plain(card):
    """d(Σ maps · weights)/d(surfels) through `rasterize_tiled`: the kernel
    pair against the plain pair, rtol 2e-3 / atol 2e-4 of the largest
    gradient."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g0 = make_object(0, n=1024, kind="sphere", device=card)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=card)
    grads = {}
    for impl in ("cuda", "plain"):
        gg = g0.clone().requires_grad_(True)
        out = rz.rasterize_tiled(gg, cam["cam_view"], cam["cam_view_proj"],
                                 torch.ones(3, device=card), 64, 64,
                                 max_per_tile=256, chunk=64, impl=impl)
        gen = torch.Generator().manual_seed(2)
        sum((v * torch.randn(v.shape, generator=gen).to(card)).sum()
            for v in out.values()).backward()
        grads[impl] = gg.grad
    scale = float(grads["plain"].abs().max())
    torch.testing.assert_close(grads["cuda"], grads["plain"], rtol=2e-3,
                               atol=2e-4 * scale)


@pytest.mark.cuda
def test_checkpointed_render_recomputes_the_pair_bit_for_bit(card):
    """`vae_trainer.render_lods(remat=True)` on the card: the backward runs
    K2a again (one launch more per view), and the gradient is bit-equal to
    the render without the checkpoint."""
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    from gaussiananything_tpu_torch.train.vae_trainer import render_lods
    b = make_batch(seed=1, batch=1, n_views_in=1, n_views_sup=2, res=64,
                   n_pts=64, n_splats=1024, device=card)
    grads, launches = [], []
    for remat in (False, True):
        g = b["gt_gaussians"].clone().requires_grad_(True)
        k2a = rasterize_cuda.composite_entries.launches
        out = render_lods([g], b["cam_view"], b["cam_view_proj"],
                          torch.ones(3, device=card), [64], remat=remat)[0]
        gen = torch.Generator().manual_seed(2)
        sum((v * torch.randn(v.shape, generator=gen).to(card)).sum()
            for v in out.values()).backward()
        grads.append(g.grad)
        launches.append(rasterize_cuda.composite_entries.launches - k2a)
    assert launches == [2, 4]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_impl_cuda_launches_k1_without_grad_and_the_pair_with(card):
    """`rasterize_tiled(impl="cuda")` launches K2a (and K2b in the backward)
    only where autograd will ask for a gradient, and K1 otherwise."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g0 = make_object(0, n=1024, kind="sphere", device=card)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=card)

    def render(g):
        return rz.rasterize_tiled(g, cam["cam_view"], cam["cam_view_proj"],
                                  torch.ones(3, device=card), 64, 64,
                                  max_per_tile=256, chunk=64)

    def counts():
        return (rasterize_cuda.composite.launches,
                rasterize_cuda.composite_entries.launches,
                rasterize_cuda.composite_backward.launches)

    c0 = counts()
    render(g0)
    with torch.no_grad():
        render(g0.clone().requires_grad_(True))
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (2, 0, 0)
    g = g0.clone().requires_grad_(True)
    render(g)["image"].sum().backward()
    c2 = counts()
    assert (c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]) == (0, 1, 1)
    assert torch.isfinite(g.grad).all() and float(g.grad.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,res,mpt,chunk", [(1024, 64, 256, 64),
                                             (73728, 512, 2048, 256)])
def test_k6_matches_plain_and_k1(card, n, res, mpt, chunk):
    """K6 reads the segment-ordered table; it shares K1's arithmetic, so
    its buffer is K1's bit for bit."""
    tab, pairs, starts, counts, bg, _, _ = args = _frame(card, n, res, mpt)
    seg = rz.segment_table(tab, pairs)
    before = rasterize_cuda.composite_segments.launches
    got = rasterize_cuda.composite_segments(seg, starts, counts, bg, res,
                                            res, chunk=chunk)
    torch.cuda.synchronize()
    assert rasterize_cuda.composite_segments.launches == before + 1
    assert torch.equal(got, rasterize_cuda.composite(*args, chunk=chunk))
    ref = rz.composite_segments_plain(seg, starts, counts, bg, res, res,
                                      chunk=chunk)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_k6_reads_no_row_past_a_tiles_count(card):
    """A table cut to its live rows, with a chunk above max_per_tile: the
    kernel copies only the rows below each tile's count, so the buffer is
    the padded table's."""
    n, res, mpt, chunk = 1024, 64, 128, 256
    tab, pairs, starts, counts, bg, _, _ = _frame(card, n, res, mpt)
    seg = rz.segment_table(tab, pairs)
    end = int((starts + counts).max())
    assert end < seg.shape[0]
    want = rasterize_cuda.composite_segments(seg, starts, counts, bg, res,
                                             res, chunk=chunk)
    got = rasterize_cuda.composite_segments(seg[:end].clone(), starts, counts,
                                            bg, res, res, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _lists(card, n, res, tile, mpt, opacity=None, radius=1.8):
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(0, n=n, kind="sphere", device=card)
    if opacity is not None:
        g[:, 3] = opacity
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [(20, 45)])[0], device=card)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    lists, counts = rz.build_tile_lists(sp, res, res, tile, mpt)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    px, py = rz.tile_pixel_tables(
        torch.arange(counts.shape[0], device=card), res // tile, tile)
    return geom, feat, counts, px, py


def _assert_lists_close(got, ref):
    """atol 2e-5 / rtol 1e-4 on every channel but the median depth
    (channel 5), a knife edge held by flips: at most 1e-4 of the pixels
    beyond that, none beyond 0.2."""
    keep = [c for c in range(rz.LIST_OUT_W) if c != 5]
    torch.testing.assert_close(got[..., keep], ref[..., keep], atol=2e-5,
                               rtol=1e-4)
    d = (got[..., 5] - ref[..., 5]).abs()
    beyond = d > 2e-5 + 1e-4 * ref[..., 5].abs()
    assert float(beyond.double().mean()) <= 1e-4 and float(d.max()) <= 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("n,res,tile,mpt,chunk", [(1024, 64, 16, 256, 64),
                                                  (73728, 512, 16, 2048, 256),
                                                  (6144, 256, 8, 512, 128)])
def test_k3_matches_plain(card, n, res, tile, mpt, chunk, with_aux):
    geom, feat, counts, px, py = _lists(card, n, res, tile, mpt)
    before = rasterize_cuda.composite_lists.launches
    got = rasterize_cuda.composite_lists(geom, feat, counts, res // tile,
                                         tile, chunk, with_aux=with_aux)
    torch.cuda.synchronize()
    assert rasterize_cuda.composite_lists.launches == before + 1
    _assert_lists_close(got, rz.composite_lists_plain(
        geom, feat, counts, px, py, chunk, with_aux=with_aux))
    if not with_aux:
        assert float(got[..., 6].abs().max()) == 0.0


@pytest.mark.cuda
def test_k3_aux_dist_matches_plain(card):
    """dist from the prefix forms where it stands above its fp32 floor."""
    geom, feat, counts, px, py = _lists(card, 73728, 512, 16, 2048, 0.2, 0.6)
    got = rasterize_cuda.composite_lists(geom, feat, counts, 32, 16, 32,
                                         with_aux=True)
    ref = rz.composite_lists_plain(geom, feat, counts, px, py, 32,
                                   with_aux=True)
    peak = float(ref[..., 6].abs().max())
    assert peak >= 1e-4
    assert float((got[..., 6] - ref[..., 6]).abs().max()) <= 2e-2 * peak


@pytest.mark.cuda
@pytest.mark.parametrize("n,res,tile,mpt,chunk,group", [
    (1024, 64, 16, 256, 64, 4), (73728, 512, 16, 2048, 256, 16),
    (73728, 512, 8, 512, 128, 16)])
def test_k4_matches_plain(card, n, res, tile, mpt, chunk, group):
    geom, feat, counts, px, py = _lists(card, n, res, tile, mpt)
    order = torch.sort(-counts, stable=True).indices
    counts_s = counts[order]
    args = (counts_s.reshape(-1, group).amax(1).int(), geom[order],
            feat[order], px[order], py[order], counts_s.float()[:, None])
    before = rasterize_cuda.composite_lists_grouped.launches
    got = rasterize_cuda.composite_lists_grouped(*args, group, chunk)
    torch.cuda.synchronize()
    assert rasterize_cuda.composite_lists_grouped.launches == before + 1
    _assert_lists_close(got, rz.composite_lists_plain(
        args[1], args[2], counts_s, args[3], args[4], chunk))
    assert float(got[..., 6].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,res,tile,mpt,chunk,group", [
    (1024, 64, 16, 256, 64, 4), (73728, 512, 16, 2048, 256, 16),
    (73728, 512, 8, 512, 128, 8)])
def test_k5_matches_plain(card, n, res, tile, mpt, chunk, group):
    geom, feat, counts, px, py = _lists(card, n, res, tile, mpt)
    before = rasterize_cuda.composite_lists_unrolled.launches
    got = rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, res // tile, tile, chunk, group)
    torch.cuda.synchronize()
    assert rasterize_cuda.composite_lists_unrolled.launches == before + 1
    _assert_lists_close(got, rz.composite_lists_plain(
        geom, feat, counts, px, py, chunk))
    assert float(got[..., 6].abs().max()) == 0.0


def _k4_args(geom, feat, counts, px, py, group):
    """K4's inputs as `rasterize_tiled_v2` forms them, and the permutation
    back to natural order."""
    order = torch.sort(-counts, stable=True).indices
    counts_s = counts[order]
    args = (counts_s.reshape(-1, group).amax(1).int().contiguous(),
            geom[order].contiguous(), feat[order].contiguous(),
            px[order].contiguous(), py[order].contiguous(),
            counts_s.float()[:, None].contiguous())
    return args, torch.sort(order, stable=True).indices


# (tile, max_per_tile, chunk, group, opacity or None): 6,144 splats at 256²
K345_CASES = [(tile, mpt, chunk, group, None)
              for tile, mpt, chunk in ((8, 512, 128), (16, 1024, 128))
              for group in (2, 4, 8, 16)]
K345_CASES += [(8, 512, 64, 16, 0.95), (16, 1024, 64, 16, 0.95),
               (8, 512, 128, 32, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,mpt,chunk,group,opacity", K345_CASES)
def test_k4_and_k5_equal_k3_bit_for_bit(card, tile, mpt, chunk, group,
                                        opacity):
    """K3, K4 and K5 share `composite_list_rows`; skipping a chunk per tile
    (K3), per cluster (K4) or not at all (K5) changes no bit. Runs of the
    same inputs are bit-equal. K4 at group 32 runs clusters of 16."""
    geom, feat, counts, px, py = _lists(card, 6144, 256, tile, mpt, opacity)
    tiles_x = 256 // tile
    k3 = rasterize_cuda.composite_lists(geom, feat, counts, tiles_x, tile,
                                        chunk)
    args, inv = _k4_args(geom, feat, counts, px, py, group)
    k4 = [rasterize_cuda.composite_lists_grouped(*args, group, chunk)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(k4[0][inv], k3)
    assert torch.equal(k4[0], k4[1])
    if group == 32:     # K5 at the same frame is one of the cases above
        assert rasterize_cuda.cluster_size(
            group, rasterize_cuda.cluster_limit(tile * tile, chunk)) == 16
        return
    k5 = [rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, tiles_x, tile, chunk, group) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(k5[0], k3)
    assert torch.equal(k5[0], k5[1])


@pytest.mark.cuda
def test_k4_runs_each_group_of_16_as_one_cluster(card):
    """The card schedules clusters of 16 K4 blocks at every frame the repo
    launches K4 at, so a group of up to 16 is one cluster."""
    for P, chunk in ((256, 256), (64, 128), (256, 64), (256, 128)):
        assert rasterize_cuda.cluster_limit(P, chunk) == 16
        assert rasterize_cuda.library("v1").ga_grouped_clusters(
            16, P, chunk) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
def test_k5_takes_the_tiles_heaviest_first(card, tile):
    """The order K5's blocks take the tiles in, which the launch computes on
    the card and writes: by descending count, ties by id, as a stable sort
    gives it; the output in natural order all the same."""
    geom, feat, counts, px, py = _lists(card, 6144, 256, tile, 512)
    n_tiles, M = counts.shape[0], geom.shape[1]
    lib = rasterize_cuda.library("v1")
    order = torch.full((n_tiles,), -1, dtype=torch.int32, device=card)
    out = torch.empty((n_tiles, tile * tile, rz.LIST_OUT_W), device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    assert lib.ga_composite_lists_unrolled(
        geom.data_ptr(), feat.data_ptr(), counts.data_ptr(),
        order.data_ptr(), n_tiles, M, 256 // tile, tile, 128, 4, 0,
        out.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(order, torch.sort(counts, descending=True,
                                         stable=True).indices.int())
    assert int(counts[order[0]]) == int(counts.max())
    assert torch.equal(out, rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, 256 // tile, tile, 128, 4))


@pytest.mark.cuda
def test_k4_k5_wrappers_refuse_bad_inputs(card):
    """What the cluster and double-buffer launches do not take raises: a
    tile other than 8 or 16, a chunk above 256 rows (whose two buffers K3's
    limit keeps within 48 KB), a group that does not divide the tiles; at
    the C interface, the same chunk and a cluster that does not divide the
    group."""
    geom, feat, counts, px, py = _lists(card, 1024, 64, 16, 256)
    args, _ = _k4_args(geom, feat, counts, px, py, 4)
    with pytest.raises(ValueError, match="8x8 or 16x16"):
        rasterize_cuda.composite_lists_unrolled(geom, feat, counts, 4, 12,
                                                64, 4)
    with pytest.raises(ValueError, match="64 or 256 pixels"):
        rasterize_cuda.composite_lists_grouped(
            args[0], *args[1:3], args[3][:, :100].contiguous(),
            args[4][:, :100].contiguous(), args[5], 4, 64)
    g2, f2 = geom.repeat(1, 8, 1), feat.repeat(1, 8, 1)   # 2048 rows
    args2, _ = _k4_args(g2, f2, counts, px, py, 4)
    with pytest.raises(ValueError, match="at most 256 splats"):
        rasterize_cuda.composite_lists_unrolled(g2, f2, counts, 4, 16, 512,
                                                4)
    with pytest.raises(ValueError, match="at most 256 splats"):
        rasterize_cuda.composite_lists_grouped(*args2, 4, 512)
    with pytest.raises(ValueError, match="not a multiple of the group 3"):
        rasterize_cuda.composite_lists_grouped(*args, 3, 64)
    lib = rasterize_cuda.library("v1")
    out = torch.empty((16, 256, rz.LIST_OUT_W), device=card)
    gmax, g, f, x, y, cnt = args
    stream = torch.cuda.current_stream(card).cuda_stream
    assert lib.ga_composite_lists_grouped(
        gmax.data_ptr(), g.data_ptr(), f.data_ptr(), x.data_ptr(),
        y.data_ptr(), cnt.data_ptr(), 16, 4, 3, 256, 256, 64, out.data_ptr(),
        stream) != 0
    gmax2, g2s, f2s, x2, y2, cnt2 = args2
    assert lib.ga_composite_lists_grouped(
        gmax2.data_ptr(), g2s.data_ptr(), f2s.data_ptr(), x2.data_ptr(),
        y2.data_ptr(), cnt2.data_ptr(), 16, 4, 4, 256, 2048, 512,
        out.data_ptr(), stream) != 0
    order = torch.empty(16, dtype=torch.int32, device=card)
    assert lib.ga_composite_lists_unrolled(
        g2.data_ptr(), f2.data_ptr(), counts.data_ptr(), order.data_ptr(), 16,
        2048, 4, 16, 512, 4, 0, out.data_ptr(), stream) != 0
    before = rasterize_cuda.composite_lists_grouped.launches
    with pytest.raises(RuntimeError, match="K4 launch failed"):
        kernel_lib.check(lib.ga_composite_lists_grouped(
            gmax.data_ptr(), g.data_ptr(), f.data_ptr(), x.data_ptr(),
            y.data_ptr(), cnt.data_ptr(), 16, 4, 17, 256, 256, 64,
            out.data_ptr(), stream), "K4")
    assert rasterize_cuda.composite_lists_grouped.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("field_major", [False, True])
def test_stage_kernels_match_plain(card, stage, field_major):
    from gaussiananything_tpu_torch.tools import kernel_stages as ks
    gmax, *row = ks.make_inputs(1, card)
    args = ks.to_field_major(*row) if field_major else row
    before = rasterize_cuda.stage.launches[(stage, field_major)]
    got = rasterize_cuda.stage(stage, gmax, *args, ks.G, ks.CHUNK,
                               field_major=field_major)
    torch.cuda.synchronize()
    assert rasterize_cuda.stage.launches[(stage, field_major)] == before + 1
    torch.testing.assert_close(
        got, rz.stage_plain(stage, gmax, *args, ks.G, ks.CHUNK,
                            field_major=field_major), atol=2e-5, rtol=1e-4)


def _stage_scene(card, scene, group):
    """The stage tool's 64 tiles in groups of `group`, seeded (some groups'
    gmax short of M) or its witness (tile 0 saturating at the end of chunk
    1 while its group runs on)."""
    from gaussiananything_tpu_torch.tools import kernel_stages as ks
    make = ks.make_witness if scene == "witness" else ks.make_inputs
    gmax, *row = make(1, card, group=group, n_groups=64 // group)
    return gmax, row


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["seeded", "witness"])
@pytest.mark.parametrize("group", [1, 2, 8, 16])
@pytest.mark.parametrize("field_major", [False, True])
def test_stage_kernels_hold_plain_at_every_group(card, scene, group,
                                                 field_major):
    """Each group one cluster, up to 16 blocks: every stage against
    `stage_plain` to atol 2e-5 / rtol 1e-4, on the seeded scene (some
    groups stop at their gmax) and on the witness (a per-tile exit would
    differ there)."""
    from gaussiananything_tpu_torch.tools import kernel_stages as ks
    gmax, row = _stage_scene(card, scene, group)
    M = row[0].shape[1]
    if scene == "seeded":
        assert int(gmax.min()) < M
    args = ks.to_field_major(*row) if field_major else row
    assert rasterize_cuda.stage_clusters(3, field_major, group, ks.P,
                                         ks.CHUNK) >= 1
    for stage in range(4):
        got = rasterize_cuda.stage(stage, gmax, *args, group, ks.CHUNK,
                                   field_major=field_major)
        ref = rz.stage_plain(stage, gmax, *args, group, ks.CHUNK,
                             field_major=field_major)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
        assert torch.equal(got, rasterize_cuda.stage(
            stage, gmax, *args, group, ks.CHUNK, field_major=field_major))


@pytest.mark.cuda
def test_stage_kernels_take_an_odd_row_major_chunk(card):
    """The paired walk's last pair of an odd chunk holds one row."""
    from gaussiananything_tpu_torch.tools import kernel_stages as ks
    gmax, *row = ks.make_witness(2, card, chunk=31, n_chunks=4)
    for stage in range(4):
        torch.testing.assert_close(
            rasterize_cuda.stage(stage, gmax, *row, ks.G, 31),
            rz.stage_plain(stage, gmax, *row, ks.G, 31), atol=2e-5,
            rtol=1e-4)


@pytest.mark.cuda
def test_stage_wrapper_refuses_a_group_or_chunk_it_cannot_run(card):
    """A group is one cluster: 32 tiles, which the card does not schedule
    as one cluster, raise before the launch (no launch counted); so does a
    field-major chunk that is not a multiple of 4 (each field's run is one
    16-byte aligned bulk copy). The C interface refuses both."""
    from gaussiananything_tpu_torch.tools import kernel_stages as ks
    gmax, row = _stage_scene(card, "seeded", 32)
    assert rasterize_cuda.stage_clusters(2, False, 32, ks.P, ks.CHUNK) == 0
    before = dict(rasterize_cuda.stage.launches)
    with pytest.raises(ValueError, match="one cluster"):
        rasterize_cuda.stage(2, gmax, *row, 32, ks.CHUNK)
    gmax30, *row30 = ks.make_inputs(1, card, chunk=30, n_chunks=2)
    field30 = ks.to_field_major(*row30)
    with pytest.raises(ValueError, match="multiple of 4"):
        rasterize_cuda.stage(2, gmax30, *field30, ks.G, 30, field_major=True)
    assert rasterize_cuda.stage.launches == before
    lib = rasterize_cuda.library("v1")
    stream = torch.cuda.current_stream(card).cuda_stream
    out = torch.empty((64, ks.P, 16), device=card)
    ptrs = [x.data_ptr() for x in (gmax, *row)]
    assert lib.ga_stage(2, 0, *ptrs, 64, 32, ks.P, row[0].shape[1],
                        ks.CHUNK, out.data_ptr(), stream) != 0
    ptrs30 = [x.data_ptr() for x in (gmax30, *field30)]
    assert lib.ga_stage(2, 1, *ptrs30, 64, ks.G, ks.P, 60, 30,
                        out.data_ptr(), stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_aux", [False, True])
def test_k3_takes_the_tiles_heaviest_first_and_repeats(card, with_aux):
    """K3's blocks take the tiles by descending count, ties by id, on a
    frame whose counts are not in that order; the output stays in natural
    order, equal to the wrapper's and bit-equal run to run."""
    geom, feat, counts, px, py = _lists(card, 6144, 256, 16, 512)
    n_tiles, M = counts.shape[0], geom.shape[1]
    heaviest = torch.sort(counts, descending=True, stable=True).indices
    assert not torch.equal(heaviest, torch.arange(n_tiles, device=card))
    lib = rasterize_cuda.library("v1")
    order = torch.full((n_tiles,), -1, dtype=torch.int32, device=card)
    out = torch.empty((n_tiles, 256, rz.LIST_OUT_W), device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    assert lib.ga_composite_lists(
        geom.data_ptr(), feat.data_ptr(), counts.data_ptr(),
        order.data_ptr(), n_tiles, M, 16, 16, 128, 0, int(with_aux),
        out.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(order, heaviest.int())
    runs = [rasterize_cuda.composite_lists(geom, feat, counts, 16, 16, 128,
                                           with_aux=with_aux)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(out, runs[0])
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_v1_fused_gradient_matches_plain_route(card):
    """`rasterize_tiled_v1_fused`: K3 forward, the K2a/K2b route recomputed
    in the backward, against the plain pair's gradient."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g0 = make_object(0, n=1024, kind="sphere", device=card)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=card)
    args = (cam["cam_view"], cam["cam_view_proj"],
            torch.ones(3, device=card), 64, 64)
    grads = {}
    for name, fn in (("fused", rz.rasterize_tiled_v1_fused),
                     ("plain", lambda *a, **k: rz.rasterize_tiled(
                         *a, impl="plain", **k))):
        gg = g0.clone().requires_grad_(True)
        out = fn(gg, *args, max_per_tile=256, chunk=64)
        gen = torch.Generator().manual_seed(2)
        sum((out[k] * torch.randn(out[k].shape, generator=gen).to(card)
             ).sum() for k in sorted(out)).backward()
        grads[name] = gg.grad
    scale = float(grads["plain"].abs().max())
    torch.testing.assert_close(grads["fused"], grads["plain"], rtol=2e-3,
                               atol=2e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,res", [(6144, 256), (73728, 512)])
def test_k2b_runs_again_on_one_retained_k2a_forward(card, n, res):
    """The adaptive GAN weight takes two gradients through the step's own
    finest render before the step's backward: K2b three times on the
    tensors one K2a forward saved (`retain_graph`). Each is bit-equal to
    K2b after a fresh forward under the same cotangent, and the first
    cotangent's gradient is the same again after the second's."""
    tab, *rest = _frame(card, n, res, 1024)
    gen = torch.Generator().manual_seed(3)
    cts = [torch.randn((rz.N_OUT, res, res), generator=gen).to(card)
           for _ in range(2)]

    def counts():
        return (rasterize_cuda.composite_entries.launches,
                rasterize_cuda.composite_backward.launches)

    c0 = counts()
    leaf = tab.clone().requires_grad_(True)
    buf = rasterize_cuda.composite_train(leaf, *rest)
    retained = [torch.autograd.grad((buf * ct).sum(), leaf,
                                    retain_graph=True)[0]
                for ct in (cts[0], cts[1], cts[0])]
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 3)
    assert torch.equal(retained[0], retained[2])
    for ct, got in zip(cts, retained):
        fresh = tab.clone().requires_grad_(True)
        want, = torch.autograd.grad(
            (rasterize_cuda.composite_train(fresh, *rest) * ct).sum(), fresh)
        assert torch.equal(got, want)
    assert float(retained[0].abs().max()) > 0


def _small_vae_and_batch(card):
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    from gaussiananything_tpu_torch.models.vae import PointVAE
    torch.manual_seed(0)
    with torch.device(card):
        model = PointVAE(latent_num=12, z_channels=4, encoder_width=64,
                         decoder_width=64, decoder_depth=1, decoder_heads=2,
                         up_factors=(4,), up_depths=(1,),
                         release_parity=False, with_encoder=True)
    batch = make_batch(seed=0, batch=2, n_views_in=2, n_views_sup=2, res=32,
                       n_pts=64, n_splats=256, device=card)
    batch.pop("gt_gaussians")
    return model, batch


@pytest.mark.cuda
def test_disc_step_and_evaluation_launch_only_k1(card):
    """Renders without gradient stay on the forward-only kernel: the
    discriminator's step launches K1 once per view of the finest LoD, the
    evaluation once per view of every LoD, neither K2a nor K2b."""
    from gaussiananything_tpu_torch.train.evaluation import eval_novelview
    from gaussiananything_tpu_torch.train.losses import PatchDiscriminator
    from gaussiananything_tpu_torch.train.state import TrainState
    from gaussiananything_tpu_torch.train.vae_trainer import (VAELossConfig,
                                                              make_disc_step)
    model, batch = _small_vae_and_batch(card)
    cfg = VAELossConfig(lod_resolutions=(16, 32))
    with torch.device(card):
        disc = PatchDiscriminator(ch=32, layers=2)
    gen = torch.Generator().manual_seed(0)

    def counts():
        return (rasterize_cuda.composite.launches,
                rasterize_cuda.composite_entries.launches,
                rasterize_cuda.composite_backward.launches)

    c0 = counts()
    logs = make_disc_step(model, disc, cfg)(TrainState.create(disc), batch,
                                            generator=gen)
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (2 * 2, 0, 0)
    m = eval_novelview(model, dict(model.named_parameters()), batch,
                       cfg.lod_resolutions, generator=gen)
    c2 = counts()
    assert (c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]) == (2 * 2 * 2, 0, 0)
    assert torch.isfinite(logs["d_loss"]) and all(
        v == v for v in m.values())


def _band_args(card, n_bands, i, n=4096, res=256, mpt=1024, seed=3):
    """Band i of n_bands of the big-splat scene, whose splats cross the
    band edges: projected and tabled against the whole image, binned with
    the band's row0 (as `render/sharded.py` renders it)."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(seed, n=n, device=card)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=card)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    band = res // n_bands
    pairs, starts, counts = rz.build_tile_pairs(sp, band, res, 16, mpt,
                                                row0=i * band)
    return (rz.splat_table(sp, res, res), pairs, starts, counts,
            torch.ones(3, device=card), band, res), i * band


def _segments(pairs, starts, counts):
    return [pairs[s:s + c].tolist() for s, c in zip(starts.tolist(),
                                                    counts.tolist())]


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [2, 4])
def test_k1_k2a_k2b_bands_match_plain(card, n_bands):
    """Each band with its row0: K1 and K2a (bit-equal to each other, the
    entry states, executed chunks and marks) against `composite_plain(...,
    row0)`, K2b against `composite_plain_backward(..., row0)`, with the
    tolerances of the whole-view tests above. (A band of empty sky
    executes nothing; the bands below the first must.)"""
    executed = []
    for i in range(n_bands):
        args, row0 = _band_args(card, n_bands, i)
        tab, pairs, starts, counts, bg, band, res = args
        k1 = rasterize_cuda.composite(*args, chunk=128, row0=row0)
        buf, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
            *args, chunk=128, row0=row0)
        assert torch.equal(buf, k1)
        rbuf, rentries, rn_exec, rmarks = rz.composite_plain(
            *args, chunk=128, return_entries=True, row0=row0)
        assert torch.equal(n_exec, rn_exec)
        executed.append(int(n_exec.sum()))
        assert torch.equal(marks[:rmarks.shape[0]], rmarks)
        torch.testing.assert_close(buf, rbuf, atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(entries[:rentries.shape[0]], rentries,
                                   atol=2e-5, rtol=1e-4)
        ct = torch.randn((rz.N_OUT, band, res),
                         generator=torch.Generator().manual_seed(i)).to(card)
        order, seg = rasterize_cuda.splat_order(pairs, starts, counts,
                                                tab.shape[0])
        got = rasterize_cuda.composite_backward(
            tab, pairs, starts, counts, bg, ct, off, entries, n_exec, marks,
            order, seg, band, res, chunk=128, row0=row0)
        ref = rz.composite_plain_backward(tab, pairs, starts, counts, bg,
                                          ct, band, res, chunk=128,
                                          row0=row0)
        err, peak = (got - ref).abs().amax(0), ref.abs().amax(0)
        assert (err <= 2e-3 * peak + 1e-12).all(), (err / peak).tolist()
    assert sum(executed[1:]) > 0, executed


@pytest.mark.cuda
def test_k1_bands_join_to_the_whole_view(card):
    """The joined K1 bands equal the whole view's K1 bit for bit on every
    tile whose pair list the band binned alike (a band clamps a big
    splat's footprint about its own rows, so a few lists differ), and
    those are most of the tiles."""
    whole, _ = _band_args(card, 1, 0)
    full = rasterize_cuda.composite(*whole, chunk=128)
    w_seg = _segments(*whole[1:4])
    tiles_x, same = whole[-1] // 16, 0
    for i in range(4):
        args, row0 = _band_args(card, 4, i)
        got = rasterize_cuda.composite(*args, chunk=128, row0=row0)
        for t, lst in enumerate(_segments(*args[1:4])):
            ty, tx = divmod(t, tiles_x)
            if lst != w_seg[(row0 // 16 + ty) * tiles_x + tx]:
                continue
            same += 1
            ys, xs = slice(ty * 16, ty * 16 + 16), slice(tx * 16, tx * 16 + 16)
            assert torch.equal(got[:, ys, xs],
                               full[:, row0 + ty * 16:row0 + ty * 16 + 16,
                                    xs]), (i, t)
    assert same >= 0.9 * tiles_x * tiles_x, same


# ----------------------------------------------- the DiT's CUDA graphs


def _graph_dit(card, stage: int, depth: int = 2):
    """A release-width DiT (1024 wide, 16 heads) cut to `depth` blocks."""
    from gaussiananything_tpu_torch.models.dit import PointDiT
    torch.manual_seed(0)
    with torch.device(card):
        return PointDiT(in_channels=3 if stage == 1 else 10, width=1024,
                        depth=depth, heads=16, cond_dim=1024,
                        vector_dim=1024, use_xyz_pe=stage == 2).eval()


def _graph_args(card, stage: int, seed: int, batch: int = 2):
    """The cascade's CFG-batched inputs: x (B, 768, 3 or 10), t, 1,369
    DINOv2 tokens, the pooled vector and, for stage 2, the xyz."""
    g = torch.Generator(device=card).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=card)
    return (r(batch, 768, 3 if stage == 1 else 10),
            torch.rand((batch,), generator=g, device=card),
            r(batch, 1369, 1024), r(batch, 1024),
            0.3 * r(batch, 768, 3) if stage == 2 else None)


def _graph_call(m, args):
    return m(*args[:4], xyz=args[4])


def _graph_counts(rec):
    names = [s.name for s in rec.spans()]
    return names.count("ga.dit.capture"), names.count("ga.dit.replay")


def _rel(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["highest", "default"])
@pytest.mark.parametrize("stage", [1, 2])
def test_dit_graph_matches_eager(card, stage, policy):
    """Call 1 runs eagerly, call 2 captures and replays, calls 3-4 replay,
    each on new inputs: within 1e-6 of the largest |velocity| of the eager
    body on the same inputs, under either matmul policy (the same kernels
    on the same data; printed: whether bit-equal)."""
    from gaussiananything_tpu_torch.utils import precision, profiling
    m = _graph_dit(card, stage)
    precision.set_policy(policy)
    try:
        outs = []
        with torch.no_grad(), profiling.recording(card) as rec:
            for seed in range(4):
                args = _graph_args(card, stage, seed)
                outs.append((_graph_call(m, args), m._forward_body(*args)))
        assert _graph_counts(rec) == (1, 3)
    finally:
        precision.set_policy("highest")
    for i, (got, ref) in enumerate(outs):
        print(f"stage {stage} {policy} call {i}: bit-equal "
              f"{torch.equal(got, ref)}, relative {_rel(got, ref):.3e}")
        assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-6


@pytest.mark.cuda
def test_dit_graph_pre_hook_sees_every_call(card):
    """The benchmark's `Recorder` keeps each call's input from a forward
    pre-hook: under replay the hook still fires once per evaluation, with
    that evaluation's input."""
    from gaussiananything_tpu_torch.utils import profiling
    m = _graph_dit(card, 2)
    seen, sent = [], []
    m.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append(args[0][:1].clone()),
        with_kwargs=True)
    with torch.no_grad(), profiling.recording(card) as rec:
        for seed in range(5):
            args = _graph_args(card, 2, seed)
            sent.append(args[0][:1].clone())
            _graph_call(m, args)
    assert _graph_counts(rec) == (1, 4)
    assert len(seen) == 5
    assert all(torch.equal(a, b) for a, b in zip(seen, sent))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["functional_call", "bf16", "matmul_policy",
                                  "batch", "grad"])
def test_dit_graph_rekeys_when_a_replay_would_differ(card, case):
    """After a key is captured, a change that a replay would get wrong
    gives a new key: the first call after it runs eagerly, the second
    captures anew, both equal the eager body under the change; where the
    change is undone, the first graph replays again. With gradients on
    the call stays eager and captures nothing."""
    from gaussiananything_tpu_torch.utils import precision, profiling
    m = _graph_dit(card, 2)
    args = _graph_args(card, 2, 0)
    with torch.no_grad():
        base = m._forward_body(*args)
        for _ in range(2):
            _graph_call(m, args)

    def call(a):
        return _graph_call(m, a)

    def ref(a):
        return m._forward_body(*a)

    new = args
    if case == "functional_call":
        params = {k: (1.01 * v).detach() for k, v in m.named_parameters()}

        def call(a):                                      # noqa: F811
            return torch.func.functional_call(m, params, a[:4],
                                              {"xyz": a[4]})

        def ref(a):                                       # noqa: F811
            with torch.enable_grad():                     # stays eager
                return call(a).detach()
    elif case == "bf16":
        m.to(torch.bfloat16)
    elif case == "matmul_policy":
        precision.set_policy("default")
    elif case == "batch":
        new = _graph_args(card, 2, 0, batch=3)
    try:
        if case == "grad":
            with torch.enable_grad(), profiling.recording(card) as rec:
                got = call(args)
            assert got.requires_grad and _graph_counts(rec) == (0, 0)
            assert len(m._graphs.entries) == 1
            assert _rel(got.detach(), base) <= 1e-6
            return
        with torch.no_grad():
            want = ref(new)
            with profiling.recording(card) as rec:
                got = [call(new) for _ in range(3)]
            assert _graph_counts(rec) == (1, 2)
            assert len(m._graphs.entries) == 2
            for g in got:
                assert _rel(g, want) <= 1e-6
            if case != "batch":
                assert _rel(want, base) > 1e-4
            if case in ("functional_call", "matmul_policy"):
                precision.set_policy("highest")
                with profiling.recording(card) as rec:
                    again = _graph_call(m, args)
                assert _graph_counts(rec) == (0, 1)
                assert _rel(again, base) <= 1e-6
    finally:
        precision.set_policy("highest")


@pytest.mark.cuda
def test_dit_graph_count_stays_within_its_limit(card):
    """Keys that never come back capture nothing; keys that come back
    twice each are captured, and the module keeps at most `LIMIT`."""
    from gaussiananything_tpu_torch.utils import profiling
    m = _graph_dit(card, 1, depth=1)
    limit = m._graphs.LIMIT
    with torch.no_grad(), profiling.recording(card) as rec:
        for b in range(1, 2 * limit + 2):
            _graph_call(m, _graph_args(card, 1, b, batch=b))
            assert len(m._graphs.entries) <= limit
        assert _graph_counts(rec) == (0, 0)
        for b in range(2 * limit + 2, 3 * limit + 4):
            a = _graph_args(card, 1, b, batch=b)
            _graph_call(m, a)
            _graph_call(m, a)
            assert len(m._graphs.entries) <= limit
    assert _graph_counts(rec) == (limit + 2, limit + 2)
    assert all(e is not None for e in m._graphs.entries.values())


@pytest.mark.cuda
def test_dit_graph_under_the_profiler(card):
    """A capture inside a `torch.profiler` run works (the profile phase
    of `chip_smoke.py` captures there), and a replay's kernels are in the
    trace, as many as an eager forward launches (the benchmark's
    device-busy time and idle share read them): the replay adds only the
    copies of its inputs and of its output."""
    m = _graph_dit(card, 1, depth=1)
    args = _graph_args(card, 1, 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def device_ops(fn):
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        out = fn()
        torch.cuda.synchronize()
        prof.stop()
        return out, sum(
            1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.duration_ns() > 0 and not e.is_user_annotation())

    with torch.no_grad():
        ref, n_eager = device_ops(lambda: m._forward_body(*args))
        _graph_call(m, args)
        got, _ = device_ops(lambda: _graph_call(m, args))     # capture
        again, n_replay = device_ops(lambda: _graph_call(m, args))
    print(f"device ops: eager forward {n_eager}, replay {n_replay}")
    assert _rel(got, ref) <= 1e-6 and _rel(again, ref) <= 1e-6
    assert n_eager <= n_replay <= n_eager + 8


# ------------------------------- a view's projection and binning as a graph

def _turntable(card, seed):
    """The request's turntable shape: 73,728 splats, 8 views of 512² on
    ring `seed` of `uni_mesh_path(8)` (another elevation each seed)."""
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(seed, n=73728, device=card)[None]
    cam = cameras.pose_to_gs_camera(
        cameras.uni_mesh_path(8)[8 * seed:8 * seed + 8], device=card)
    return (g, cam["cam_view"][None], cam["cam_view_proj"][None],
            torch.ones((1, 8, 3), device=card))


def _turntable_render(inputs, chunk=256):
    from gaussiananything_tpu_torch.render.renderer import render_multiview
    return render_multiview(*inputs, 512, tile=16, max_per_tile=2048,
                            chunk=chunk)


def _frame_graph_counts(rec):
    names = [s.name for s in rec.spans()]
    return (names.count("ga.render.capture"),
            names.count("ga.render.replay"),
            names.count("ga.render.project"))


@pytest.mark.cuda
def test_frame_graph_turntable_matches_eager(card, monkeypatch):
    """Three turntables, each with other gaussians and cameras: the first
    runs view 0 eagerly, captures at view 1 and replays after; the next
    two replay all 8 views. Every map equals the eager body's on the same
    inputs bit for bit (a graph input left stale would not), and each
    turntable launches K1 exactly 8 times, outside the graph."""
    from gaussiananything_tpu_torch.utils import profiling
    rz.FRAME_GRAPHS.entries.clear()
    counts, launches, got = [], [], []
    with torch.no_grad():
        for seed in range(3):
            inputs = _turntable(card, seed)
            log = []
            rasterize_cuda.event_log = log
            try:
                with profiling.recording(card) as rec:
                    got.append(_turntable_render(inputs))
            finally:
                rasterize_cuda.event_log = None
            counts.append(_frame_graph_counts(rec))
            launches.append([k for k, _, _ in log])
        with monkeypatch.context() as m:
            m.setattr(rz, "frame_graph_engages", lambda *a: False)
            want = [_turntable_render(_turntable(card, seed))
                    for seed in range(3)]
    assert counts == [(1, 7, 2), (0, 8, 0), (0, 8, 0)]
    assert launches == [["K1"] * 8] * 3
    assert len(rz.FRAME_GRAPHS.entries) == 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert list(a) == list(b)
        for k in b:
            assert torch.equal(a[k], b[k]), (i, k)
        assert float(b["alpha"].max()) > 0.5
    for k in want[0]:
        assert not torch.equal(want[0][k], want[1][k]), k


@pytest.mark.cuda
def test_frame_graph_stays_off_where_a_gradient_is_asked(card):
    """Grad mode on and gaussians that require grad: the eager body (K2a
    and K2b, which stage 128 splats a chunk), no capture or replay span,
    every view's projection and binning spans open."""
    from gaussiananything_tpu_torch.utils import profiling
    g, cv, cvp, bg = _turntable(card, 0)
    g = g.clone().requires_grad_(True)
    before = len(rz.FRAME_GRAPHS.entries)
    with profiling.recording(card) as rec:
        out = _turntable_render((g, cv, cvp, bg), chunk=128)
    out["image"].sum().backward()
    assert _frame_graph_counts(rec) == (0, 0, 8)
    assert len(rz.FRAME_GRAPHS.entries) == before
    assert torch.isfinite(g.grad).all() and float(g.grad.abs().max()) > 0


# ---------------------------------------------- the fused attention kernel

# (queries, keys): the DiT-Ls' self- and cross-attention, DINOv2's
ATTN_SHAPES = [(768, 768), (768, 1369), (1374, 1374)]


def _attn_inputs(card, T, S, seed, B=2, H=16):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn((B, n, H, 64), generator=g, device=card)
                 for n in (T, S, S))


def _attn_plain(q, k, v):
    """`attention_plain` in the kernel's (B, tokens, H, 64) layout."""
    from gaussiananything_tpu_torch.ops.attention import attention_plain
    return attention_plain(*(t.transpose(1, 2) for t in (q, k, v))
                           ).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["highest", "default"])
@pytest.mark.parametrize("T,S", ATTN_SHAPES)
def test_attention_kernel_matches_plain(card, T, S, policy):
    """The kernel against `attention_plain` on the same card and inputs
    (B 2, H 16, unit normals), under the IEEE policy (the plain products
    in IEEE fp32) and under TF32 (the plain products in cuBLAS's TF32).
    The kernel rounds q, k, P and V to TF32 (unit roundoff 2^-11), so each
    output moves by a few 2^-11 of the largest |output| against IEEE; under
    TF32 both sides round, in other places (P before or after its
    normalisation, sums in another order): held to 4e-3 of the largest
    |output| either way, with the mean error under 2e-4 of it."""
    from gaussiananything_tpu_torch.ops import attention as attn
    from gaussiananything_tpu_torch.utils import precision
    q, k, v = _attn_inputs(card, T, S, seed=T + S)
    precision.set_policy(policy)
    try:
        ref = _attn_plain(q, k, v)
    finally:
        precision.set_policy("highest")
    before = attn.attention.launches
    got = attn.attention(q, k, v)
    torch.cuda.synchronize()
    assert attn.attention.launches == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    peak = float(ref.abs().max())
    err = (got - ref).abs()
    print(f"attention {T}x{S} against plain ({policy}): max "
          f"{float(err.max()) / peak:.3e}, mean "
          f"{float(err.mean()) / peak:.3e} of max|o| {peak:.4f}")
    assert float(err.max()) <= 4e-3 * peak
    assert float(err.mean()) <= 2e-4 * peak


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(768, 1369), (100, 70)])
def test_attention_kernel_is_the_same_run_to_run(card, T, S):
    """No atomics: two launches on the same inputs give the same bits;
    q, k, v read as views of one packed projection (the self-attention's
    layout) give the bits of the same values held contiguous."""
    from gaussiananything_tpu_torch.ops.attention import attention
    q, k, v = _attn_inputs(card, T, S, seed=1)
    a = attention(q, k, v)
    b = attention(q, k, v)
    assert torch.equal(a, b)
    if T == S:
        return
    qkv = torch.stack(_attn_inputs(card, S, S, seed=2), dim=2)
    packed = attention(*qkv.unbind(2))
    assert torch.equal(packed, attention(
        *(t.contiguous() for t in qkv.unbind(2))))


@pytest.mark.cuda
def test_attention_kernel_replays_in_a_cuda_graph(card):
    """Captured into a CUDA graph and replayed on new inputs copied into
    the captured ones, the kernel gives the eager launch's bits; the
    launch is counted and its span opened once, at the capture, with no
    device times (nothing ran then)."""
    from gaussiananything_tpu_torch.ops.attention import attention
    from gaussiananything_tpu_torch.utils import profiling
    ins = _attn_inputs(card, 768, 1369, seed=3)
    attention(*ins)                                    # build, warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = attention.launches
    with profiling.recording(card) as rec:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = attention(*ins)
        for seed in (4, 5):
            new = _attn_inputs(card, 768, 1369, seed=seed)
            for dst, src in zip(ins, new):
                dst.copy_(src)
            graph.replay()
            assert torch.equal(out, attention(*new))
    spans = [s for s in rec.spans() if s.name == "ga.kernel.attn"]
    assert attention.launches == before + 3
    assert len(spans) == 3
    assert spans[0].device_start_ns is None
    assert all(s.device_s > 0 for s in spans[1:])


@pytest.mark.cuda
def test_attention_wrapper_refuses_bad_inputs(card):
    from gaussiananything_tpu_torch.ops.attention import attention
    q, k, v = _attn_inputs(card, 128, 128, seed=6, B=1, H=2)
    bad = {
        "head dim": (torch.zeros((1, 128, 2, 32), device=card),) * 3,
        "dtype": tuple(t.to(torch.bfloat16) for t in (q, k, v)),
        "device": tuple(t.cpu() for t in (q, k, v)),
        "mixed devices": (q, k.cpu(), v),
        "layout": (torch.cat([q, q], -1)[..., ::2], k, v),
        "frame": (q, k[:, :100], v),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            attention(*args)


@pytest.mark.cuda
def test_dot_attention_routes_on_the_card(card):
    """Under TF32 a no-grad fp32 call of head dim 64 launches the kernel;
    under the IEEE policy, with grad, in bf16, with a bias or with a small
    group it does not, and gives `attention_plain`'s bits."""
    from gaussiananything_tpu_torch.models import layers
    from gaussiananything_tpu_torch.ops import attention as attn
    from gaussiananything_tpu_torch.utils import precision
    q, k, v = _attn_inputs(card, 256, 200, seed=7, B=2, H=4)
    cases = {
        "ieee": lambda: layers.dot_attention(q, k, v),
        "grad": lambda: layers.dot_attention(q.requires_grad_(), k, v),
        "bf16": lambda: layers.dot_attention(*(t.to(torch.bfloat16)
                                               for t in (q, k, v))),
        "bias": lambda: layers.dot_attention(
            q, k, v, torch.zeros((1, 1, 256, 200), device=card)),
        "group": lambda: layers.dot_attention(q[:, :9], k[:, :9], v[:, :9]),
    }
    for name, call in cases.items():
        precision.set_policy("highest" if name == "ieee" else "default")
        try:
            before = attn.attention.launches
            with torch.enable_grad():
                got = call()
            assert attn.attention.launches == before, name
        finally:
            precision.set_policy("highest")
            q.requires_grad_(False)
        assert got.dtype == (torch.bfloat16 if name == "bf16"
                             else torch.float32)
        if name == "ieee":
            assert torch.equal(got, _attn_plain(q, k, v))
    precision.set_policy("default")
    try:
        with torch.no_grad():
            before = attn.attention.launches
            got = layers.dot_attention(q, k, v)
            assert attn.attention.launches == before + 1
    finally:
        precision.set_policy("highest")
    assert torch.equal(got, attn.attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2])
def test_release_dit_forward_through_the_kernel(card, stage, monkeypatch):
    """A release-width DiT-L (24 blocks of 1024, 16 heads; 768 tokens, 1,369
    context tokens, CFG batch 2) under TF32 with its 48 attentions through
    the kernel: within the image cell's `velocity` limit (8e-3 of the
    largest |velocity|) of the plain path under IEEE, as the cell's
    reference computes, and of the plain path under TF32."""
    from gaussiananything_tpu_torch.ops import attention as attn
    from gaussiananything_tpu_torch.utils import precision
    m = _graph_dit(card, stage, depth=24)
    args = _graph_args(card, stage, seed=8)
    refs = {}
    with torch.no_grad():
        for policy in ("highest", "default"):
            precision.set_policy(policy)
            with monkeypatch.context() as mp:
                mp.setattr(attn, "plain_reasons", lambda *a: ["plain"])
                refs[policy] = m._forward_body(*args)
        precision.set_policy("default")
        try:
            before = attn.attention.launches
            got = m._forward_body(*args)
            assert attn.attention.launches == before + 48
        finally:
            precision.set_policy("highest")
    for policy, ref in refs.items():
        print(f"stage {stage} DiT-L through the kernel against the plain "
              f"path ({policy}): {_rel(got, ref):.3e}")
        assert _rel(got, ref) <= 8e-3


# ------------------------------------------------- the row-norm kernel

# (B, N, D) of the DiT-Ls' residual stream: the CFG-batched 768 tokens
ROWS_SHAPE = (2, 768, 1024)
# each mode: which of y, gate, weight and shift/scale a call gives
ROWNORM_MODES = {
    "norm": ("weight",),
    "norm+modulate": ("weight", "shift", "scale"),
    "residual+norm+modulate": ("y", "weight", "shift", "scale"),
    "gated+norm+modulate": ("y", "gate", "weight", "shift", "scale"),
    "gated+norm": ("y", "gate", "weight"),
    "gated": ("y", "gate"),
}
# (name, B, T, H, packed): q/k heads of 64 as the paths hand them over: the
# DiT-Ls' self (views of the packed qkv) and cross (to_k over the 1,369
# DINOv2 tokens), the VAE decoder's global and in-plane blocks, the three
# upsamplers' (f + 1)-token groups
QK_SHAPES = (("dit self", 2, 768, 16, True), ("dit cross k", 2, 1369, 16,
                                              False),
             ("decoder", 1, 768, 12, True), ("decoder plane", 3, 256, 12,
                                              True),
             ("upsampler x8", 768, 9, 12, True),
             ("upsampler x4", 6144, 5, 12, True),
             ("upsampler x3", 24576, 4, 12, True))
# the kernel's h against the plain version's: only the sum of squares is
# summed in another order (and rsqrtf's last bits): a few 2^-24 of the
# largest |h|
ROWNORM_REL = 4e-6


def _rows_inputs(card, seed, shape=ROWS_SHAPE):
    g = torch.Generator(device=card).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, device=card)
    B, _, D = shape
    mod = 0.5 * r(B, 6, D)
    return dict(x=r(*shape), y=r(*shape), gate=mod[:, 2],
                weight=1 + 0.1 * r(D), shift=mod[:, 0], scale=mod[:, 1])


def _rows_rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(ROWNORM_MODES))
def test_rownorm_kernel_matches_plain(card, mode):
    """At the DiT-Ls' (2, 768, 1024), with the adaLN vectors as rows of a
    (B, 6, D) table: x' bit-equal to the plain version's (the same two
    roundings), h within ROWNORM_REL of its largest |h|; one launch."""
    from gaussiananything_tpu_torch.ops import rownorm as rn
    a = _rows_inputs(card, seed=11)
    kw = {k: a[k] for k in ROWNORM_MODES[mode]}
    ref_x, ref_h = rn.rownorm_plain(a["x"], **kw)
    before = rn.rownorm.launches
    got_x, got_h = rn.rownorm(a["x"], **kw)
    torch.cuda.synchronize()
    assert rn.rownorm.launches == before + 1
    assert torch.equal(got_x, ref_x)
    if "y" not in kw:
        assert got_x is a["x"]
    if "weight" not in kw:
        assert got_h is None
        return
    assert got_h.is_contiguous() and got_h.shape == a["x"].shape
    print(f"rownorm {mode}: h {_rows_rel(got_h, ref_h):.3e} of max|h|, "
          f"bit-equal {torch.equal(got_h, ref_h)}")
    assert _rows_rel(got_h, ref_h) <= ROWNORM_REL


@pytest.mark.cuda
def test_rownorm_kernel_reads_vectors_at_any_offset(card):
    """A weight and adaLN vectors that are views at odd offsets into one
    buffer (as seeded parameters are) are read a float at a time: the
    same bits as the same values held 16-byte aligned."""
    from gaussiananything_tpu_torch.ops import rownorm as rn
    a = _rows_inputs(card, seed=21)
    D = ROWS_SHAPE[-1]
    flat = torch.empty(1 + D + 2 * 6 * D + 3, device=card)
    w = flat[1:1 + D]
    w.copy_(a["weight"])
    mod = flat[1 + D:1 + D + 2 * 6 * D].view(2, 6, D)
    mod[:, 0].copy_(a["shift"])
    mod[:, 1].copy_(a["scale"])
    mod[:, 2].copy_(a["gate"])
    assert not kernel_lib.aligned16(w)
    assert not kernel_lib.aligned16(mod[:, 0])
    odd = dict(a, weight=w, shift=mod[:, 0], scale=mod[:, 1], gate=mod[:, 2])
    assert rn.plain_reasons(**{k: v for k, v in odd.items()}) == []
    got, ref = rn.rownorm(**odd), rn.rownorm(**a)
    assert all(torch.equal(p, q) for p, q in zip(got, ref))
    q, k, wq, wk = _qk_inputs(card, 1, 768, 12, True, seed=22)
    wq_odd = flat[1:65]
    wq_odd.copy_(wq)
    assert all(torch.equal(p, r) for p, r in zip(
        rn.rownorm_pair(q, wq_odd, 1e-5, k, wk, 1e-5),
        rn.rownorm_pair(q, wq, 1e-5, k, wk, 1e-5)))


def _qk_inputs(card, B, T, H, packed, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    if packed:
        q, k, _ = torch.randn((B, T, 3, H, 64), generator=g,
                              device=card).unbind(2)
    else:
        q = torch.randn((B, 768, H, 64), generator=g, device=card)
        k = torch.randn((B, T, H, 64), generator=g, device=card)
    w = 1 + 0.1 * torch.randn((2, 64), generator=g, device=card)
    return q, k, w[0], w[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,T,H,packed", QK_SHAPES)
def test_rownorm_pair_matches_plain(card, name, B, T, H, packed):
    """q and k normalised in one launch, read through their strides (the
    packed qkv's views), each with its own weight and eps: within
    ROWNORM_REL of the plain version, written contiguous."""
    from gaussiananything_tpu_torch.ops import rownorm as rn
    q, k, wq, wk = _qk_inputs(card, B, T, H, packed, seed=T + H)
    before = (rn.rownorm.launches, rn.rownorm.norms)
    hq, hk = rn.rownorm_pair(q, wq, 1e-5, k, wk, 1e-6)
    torch.cuda.synchronize()
    assert (rn.rownorm.launches, rn.rownorm.norms) == \
        (before[0] + 1, before[1] + 2)
    for got, t, w, eps in ((hq, q, wq, 1e-5), (hk, k, wk, 1e-6)):
        ref = rn.rownorm_plain(t, weight=w, eps=eps)[1]
        assert got.is_contiguous() and got.shape == t.shape
        print(f"rownorm pair {name}: {_rows_rel(got, ref):.3e} of max|h|")
        assert _rows_rel(got, ref) <= ROWNORM_REL


@pytest.mark.cuda
def test_rownorm_kernel_is_the_same_run_to_run(card):
    """No atomics and a fixed order of the sums: two launches on the same
    inputs give the same bits, in the fused mode and the q/k pair."""
    from gaussiananything_tpu_torch.ops import rownorm as rn
    a = _rows_inputs(card, seed=12)
    first = rn.rownorm(**a)
    again = rn.rownorm(**a)
    assert all(torch.equal(p, q) for p, q in zip(first, again))
    q, k, wq, wk = _qk_inputs(card, 2, 768, 16, True, seed=13)
    assert all(torch.equal(p, r) for p, r in zip(
        rn.rownorm_pair(q, wq, 1e-5, k, wk, 1e-5),
        rn.rownorm_pair(q, wq, 1e-5, k, wk, 1e-5)))


@pytest.mark.cuda
def test_rownorm_kernel_replays_in_a_cuda_graph(card):
    """Captured into a CUDA graph and replayed on new inputs copied into
    the captured ones, the kernel gives the eager launch's bits; the
    launch is counted and its span opened once, at the capture, with no
    device times (nothing ran then)."""
    from gaussiananything_tpu_torch.ops import rownorm as rn
    from gaussiananything_tpu_torch.utils import profiling
    a = _rows_inputs(card, seed=14)
    rn.rownorm(**a)                                    # build, warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = rn.rownorm.launches
    with profiling.recording(card) as rec:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = rn.rownorm(**a)
        for seed in (15, 16):
            new = _rows_inputs(card, seed=seed)
            for key in ("x", "y", "weight"):
                a[key].copy_(new[key])
            graph.replay()
            eager = rn.rownorm(**a)
            assert all(torch.equal(p, q) for p, q in zip(out, eager))
    spans = [s for s in rec.spans() if s.name == "ga.kernel.rownorm"]
    assert rn.rownorm.launches == before + 3
    assert len(spans) == 3
    assert spans[0].device_start_ns is None
    assert all(s.device_s > 0 for s in spans[1:])


@pytest.mark.cuda
def test_rownorm_wrapper_refuses_bad_inputs(card):
    from gaussiananything_tpu_torch.ops import rownorm as rn
    a = _rows_inputs(card, seed=17, shape=(1, 64, 128))
    bad = {
        "dtype": dict(a, x=a["x"].to(torch.bfloat16)),
        "device": dict(a, y=a["y"].cpu()),
        "layout": dict(a, y=torch.cat([a["y"], a["y"]], -1)[..., ::2]),
        "unaligned": dict(a, x=torch.randn(64 * 128 + 4, device=card)[
            1:1 + 64 * 128].reshape(1, 64, 128)),
        "shape": dict(a, y=a["y"][:, :10]),
        "gate without y": dict(a, y=None),
    }
    for name, kw in bad.items():
        with pytest.raises(ValueError):
            rn.rownorm(**kw)
    with torch.enable_grad(), pytest.raises(ValueError, match="forward"):
        rn.rownorm(a["x"], weight=a["weight"].requires_grad_())


@pytest.mark.cuda
def test_norms_route_on_the_card(card):
    """A no-grad fp32 `RMSNorm` call launches the kernel and a q/k-normed
    `Attention` one pair launch; with grad on, or in bf16, the call keeps
    the plain version's bits and counts its reason in `rownorm.plain`."""
    from gaussiananything_tpu_torch.models import layers
    from gaussiananything_tpu_torch.ops import rownorm as rn
    torch.manual_seed(18)
    norm = layers.RMSNorm(1024).to(card)
    x = torch.randn(ROWS_SHAPE, device=card)
    with torch.no_grad():
        before = (rn.rownorm.launches, dict(rn.plain))
        got = norm(x)
        assert rn.rownorm.launches == before[0] + 1
        assert rn.plain == before[1]
        ref = rn.rownorm_plain(x, weight=norm.weight)[1]
        assert _rows_rel(got, ref) <= ROWNORM_REL
        attn = layers.Attention(768, 12, qk_norm=True).to(card)
        n = rn.rownorm.launches
        attn(torch.randn((1, 768, 768), device=card))
        assert rn.rownorm.launches == n + 1
    for case in ("grad", "bf16"):
        n, counted = rn.rownorm.launches, rn.plain[
            "grad" if case == "grad" else "dtype"]
        xin = x.to(torch.bfloat16) if case == "bf16" else x
        with torch.set_grad_enabled(case == "grad"):
            got = norm(xin)
        assert rn.rownorm.launches == n
        assert rn.plain["grad" if case == "grad" else "dtype"] == counted + 1
        assert torch.equal(got.detach(),
                           rn.rownorm_plain(xin, weight=norm.weight)[1]
                           .detach())


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2])
def test_release_dit_forward_through_the_rownorm_kernel(card, stage,
                                                        monkeypatch):
    """A release-width DiT-L (24 blocks of 1024, 16 heads; 768 tokens,
    1,369 context tokens, CFG batch 2) under TF32, its norms, modulations
    and residuals in 24 × 6 launches of the row-norm kernel and none kept
    plain: within the image cell's `velocity` limit (8e-3 of the largest
    |velocity|) of the plain expressions under IEEE and under TF32."""
    from gaussiananything_tpu_torch.ops import rownorm as rn
    from gaussiananything_tpu_torch.utils import precision
    m = _graph_dit(card, stage, depth=24)
    args = _graph_args(card, stage, seed=19)
    refs = {}
    with torch.no_grad():
        for policy in ("highest", "default"):
            precision.set_policy(policy)
            with monkeypatch.context() as mp:
                mp.setattr(rn, "plain_reasons", lambda *a, **kw: ["plain"])
                refs[policy] = m._forward_body(*args)
        precision.set_policy("default")
        try:
            before = (rn.rownorm.launches, sum(rn.plain.values()))
            got = m._forward_body(*args)
            assert rn.rownorm.launches == before[0] + 24 * 6
            assert sum(rn.plain.values()) == before[1]
        finally:
            precision.set_policy("highest")
    for policy, ref in refs.items():
        print(f"stage {stage} DiT-L through the row-norm kernel against the "
              f"plain expressions ({policy}): {_rel(got, ref):.3e}")
        assert _rel(got, ref) <= 8e-3
