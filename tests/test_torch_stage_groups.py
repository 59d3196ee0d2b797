"""The stage kernels' group test, and why a group cannot be split.

The stage kernels (`make_kernel(stage)` of `tools/pallas_bisect.py:25` and
`tools/pallas_bisect2.py:30`; `rasterize_cuda.stage` and its plain version
`rasterize.stage_plain` in the port) run chunk c of a group while c·chunk <
gmax and some pixel of the GROUP is above 1e-4. They have no prune: after
its T falls to 1e-4 a tile's later rows still add T·α·... to its sums and
keep shrinking T. So whether a saturated tile walks on because its partner
is live shows in the output, and on the card the group is one thread-block
cluster, never a per-tile exit. The witness scene
(`kernel_stages.make_witness`) saturates tile 0 just below 1e-4 at the end
of chunk 1 while tile 1, in its group, stays live.

Tolerance: atol 2e-5 / rtol 1e-4, the stage kernels' bound
(`tests/test_torch_raster_variants.py`: sums over a chunk in another order).
The JAX side runs the tools' own kernels in interpret mode, as
`tests/test_torch_raster_variants.py` does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tools.pallas_bisect as bisect_row
import tools.pallas_bisect2 as bisect_field
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.tools import kernel_stages
from test_torch_raster_variants import _pallas_stage

torch.set_num_threads(2)

# the stage tools' sizes, set small; four chunks, so the group runs two
# after tile 0 saturates
SIZES = dict(G=2, P=64, CHUNK=32, NC=4, NG=2)
G, CHUNK = SIZES["G"], SIZES["CHUNK"]
ATOL, RTOL = 2e-5, 1e-4
T_EPS = 1e-4


def _witness():
    gmax, *row = kernel_stages.make_witness(
        5, "cpu", G, SIZES["P"], CHUNK, SIZES["NC"], SIZES["NG"])
    return gmax, row


def _per_tile(stage, gmax, row, field_major=False):
    """`stage_plain` with each tile a group of its own under its group's
    gmax: what a per-tile exit computes."""
    return rz.stage_plain(stage, gmax.repeat_interleave(G), *row, 1, CHUNK,
                          field_major=field_major)


def _after(stage, gmax, row, n_chunks):
    """The state after the first `n_chunks` chunks, at group G."""
    cut = n_chunks * CHUNK
    return rz.stage_plain(stage, gmax, row[0][:, :cut], row[1][:, :cut],
                          row[2], row[3], G, CHUNK)


def test_the_witness_saturates_tile_0_at_the_end_of_chunk_1():
    """Tile 0 is live after chunk 0 and saturated just below 1e-4 after
    chunk 1; its partner tile 1 stays live, so the group runs on."""
    gmax, row = _witness()
    assert int(gmax[0]) == SIZES["NC"] * CHUNK
    t1 = _after(2, gmax, row, 1)[..., 0]
    t2 = _after(2, gmax, row, 2)[..., 0]
    assert float(t1[0].max()) > T_EPS
    assert 0.5 * T_EPS < float(t2[0].max()) <= T_EPS
    assert float(t2[1].max()) > T_EPS


@pytest.mark.parametrize("stage", [2, 3])
def test_a_per_tile_exit_differs_beyond_tolerance(stage):
    """On tile 0's T channel the per-tile twin stops at chunk 1 and the
    group walks on: beyond atol 2e-5 + rtol 1e-4, by at most T_EPS; its
    summed weight differs too."""
    gmax, row = _witness()
    grouped = rz.stage_plain(stage, gmax, *row, G, CHUNK)
    twin = _per_tile(stage, gmax, row)
    ref, got = grouped[0, :, 0], twin[0, :, 0]
    d = (got - ref).abs()
    assert bool((d > ATOL + RTOL * ref.abs()).any()), float(d.max())
    assert float(d.max()) <= T_EPS
    assert float(ref.max()) < float(got.max())
    w = 1 if stage == 2 else 4          # the channel of Σw
    assert not torch.equal(grouped[0, :, w], twin[0, :, w])


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("field_major", [False, True],
                         ids=["row-major", "field-major"])
def test_pallas_stage_is_the_group_test_on_the_witness(stage, field_major,
                                                        monkeypatch):
    """The JAX tools' kernel in interpret mode agrees with `stage_plain` at
    group G on the witness, and not with the per-tile twin."""
    mod = bisect_field if field_major else bisect_row
    for k, v in SIZES.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(mod, "T", SIZES["NG"] * G)
    gmax, row = _witness()
    args = kernel_stages.to_field_major(*row) if field_major else row
    ref = np.asarray(_pallas_stage(mod, stage, field_major, gmax, *args))
    got = rz.stage_plain(stage, gmax, *args, G, CHUNK,
                         field_major=field_major).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    twin = _per_tile(stage, gmax, args, field_major=field_major).numpy()
    trans = (lambda x: x[0, 0]) if field_major else (lambda x: x[0, :, 0])
    assert not np.allclose(trans(twin), trans(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stage", [0, 1])
def test_stages_0_and_1_are_the_same_under_both_groupings(stage):
    """Stages 0 and 1 never update T, so every group runs every chunk
    below its gmax and the grouping changes nothing."""
    gmax, row = _witness()
    grouped = rz.stage_plain(stage, gmax, *row, G, CHUNK)
    assert torch.equal(grouped, _per_tile(stage, gmax, row))
    assert float(grouped[..., 0].min()) == 1.0
