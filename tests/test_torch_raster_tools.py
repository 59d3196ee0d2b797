"""The port's rasterizer tools run on the CPU at a tiny shape and print what
they promise: `rasterizer_timing` (phases, a forward frame with rays/s and a
digest per entry point, forward + backward, the A/B of the two v4 feeds),
`bench` (ONE JSON line) and `kernel_stages` (a digest per stage and layout).
Times taken here are host-clock times of the plain versions and are checked
only for being there."""
from __future__ import annotations

import json
import math
import os

import pytest
import torch

from gaussiananything_tpu_torch.ops import rasterize_cuda
from gaussiananything_tpu_torch.tools import (bench, kernel_stages,
                                              rasterizer_timing)

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--res", "32", "--splats", "256", "--mpt", "128",
        "--chunk", "64"]


def test_timing_tool_all_impls():
    lines = []
    rows = rasterizer_timing.main(
        ["--all", "--group", "2", "--iters", "1", *TINY], log=lines.append)
    text = "\n".join(lines)
    assert lines[0].startswith("device=cpu res=32 N=256 tile=16 mpt=128")
    for impl in rasterizer_timing.IMPLS:
        assert f"forward frame [{impl}]" in text
        assert rows[f"forward frame [{impl}]"] > 0
    for name in ("preprocess", "binning", "composite only",
                 "forward+backward [cuda]", "segment gather",
                 "composite only [segments]"):
        assert rows[name] > 0, name
    assert text.count("forward rays/s") == len(rasterizer_timing.IMPLS)
    assert text.count("[digest ") == len(rows)
    assert "bwd/fwd ratio" in text
    assert "tab (pair indices) vs segment table" in lines[-1]
    # the v4 routes and the plain compositor compute one image; the list
    # routes keep the unflushed transmittance on top
    digest = {ln.split(":")[0].strip(): float(ln.split("[digest ")[1][:-1])
              for ln in lines if "forward frame" in ln}
    assert digest["forward frame [cuda]"] == digest["forward frame [plain]"]
    assert digest["forward frame [cuda]"] == \
        digest["forward frame [cuda_dma]"]
    assert digest["forward frame [v1]"] == pytest.approx(
        digest["forward frame [cuda]"], rel=1e-3)


def test_timing_tool_one_impl_counts_no_launch_on_cpu():
    before = rasterize_cuda.composite_lists_grouped.launches
    lines = []
    rows = rasterizer_timing.main(
        ["--impl", "v2", "--tile", "8", "--group", "8", "--iters", "1",
         *TINY], log=lines.append)
    assert set(rows) == {"preprocess", "binning", "forward frame [v2]"}
    assert rasterize_cuda.composite_lists_grouped.launches == before


def test_bench_prints_one_json_line(capsys):
    result = bench.main(["--repeats", "2", "--iters", "1", *TINY])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert json.loads(out[0]) == result
    assert set(result) == {"metric", "value", "unit", "repeats", "value_min",
                           "value_max", "frame_ms_median", "device"}
    assert result["unit"] == "rays/s" and result["repeats"] == 2
    assert result["device"] == "cpu"
    assert result["value_min"] <= result["value"] <= result["value_max"]
    assert result["value"] == pytest.approx(
        32 * 32 / result["frame_ms_median"] * 1e3, rel=1e-3)


@pytest.mark.parametrize("seed", [None, 1], ids=["ones", "seeded"])
def test_kernel_stages_prints_digests(seed):
    argv = ["--device", "cpu", "--iters", "1", "--groups", "2", "--group",
            "2", "--pixels", "64", "--chunks", "2", "--chunk", "32"]
    if seed is not None:
        argv += ["--seed", str(seed)]
    lines = []
    digests = kernel_stages.main(argv, log=lines.append)
    assert list(digests) == [f"{layout} stage {s}" for layout in
                             ("row", "field") for s in range(4)]
    assert len(lines) == 8 and all("digest" in ln for ln in lines)
    assert all(math.isfinite(v) and v > 0 for v in digests.values())
    for s in range(4):      # one function, two layouts
        assert digests[f"row stage {s}"] == pytest.approx(
            digests[f"field stage {s}"], rel=1e-5)
    if seed is None:
        # all-ones inputs: ρ = 0, α = 0.99; with 2 x 2 x 64 pixels, stage 0
        # sums nothing but T = 1, stage 1 sums 0.99 over the 64 rows
        assert digests["row stage 0"] == 256.0
        assert digests["row stage 1"] == pytest.approx(256 * (1 + 64 * 0.99))


def test_kernel_stages_one_layout():
    lines = []
    digests = kernel_stages.main(
        ["2", "3", "--layout", "field", "--device", "cpu", "--iters", "0",
         "--groups", "1", "--group", "2", "--pixels", "64", "--chunks", "1",
         "--chunk", "32"], log=lines.append)
    assert list(digests) == ["field stage 2", "field stage 3"]


def test_attribution_copies_fit_the_sources(tmp_path):
    """`kernel_attribution` finds the design of this checkout's sources and
    every instrumented or cut copy of it applies (each edit's anchor occurs
    once); the stamped copies carry the instrumentation, the committed
    sources none."""
    from gaussiananything_tpu_torch.tools import kernel_attribution as ka
    csrc = os.path.dirname(rasterize_cuda.SOURCES["fwd"])
    design = ka.design_of(csrc)
    assert design == "marked"
    for kernel, copies in ka.DESIGNS[design].items():
        assert "stamps" in copies
        for i, (copy, patches) in enumerate(copies.items()):
            out = ka.patched_csrc(csrc, str(tmp_path / f"{kernel}{i}"),
                                  patches)
            for name in patches:
                with open(os.path.join(out, name)) as f:
                    text = f.read()
                assert ("ga_stamps" in text) == (copy == "stamps"), name
    for path in (*rasterize_cuda.SOURCES.values(), *rasterize_cuda.HEADERS):
        with open(path) as f:
            assert "ga_stamps" not in f.read()


def test_attribution_list_copies_fit_the_sources(tmp_path):
    """The K3, K4, K5 and stage copies of `kernel_attribution` apply to
    this checkout's `rasterize_v1.cu` (each anchor once): its design is the
    paired one, not the cluster design it replaced; each stamped copy
    carries one start and one end stamp and the occupancy query, each cut
    copy none."""
    from gaussiananything_tpu_torch.tools import kernel_attribution as ka
    csrc = os.path.dirname(rasterize_cuda.SOURCES["v1"])
    assert ka.design_of(csrc, ka.LIST_DESIGNS) == "paired"
    old = ka.LIST_DESIGNS["cluster"]
    with pytest.raises(ValueError, match="no design"):
        ka.design_of(csrc, {"cluster": old})
    assert set(ka.LIST_DESIGNS) == {"cluster", "paired"}
    for kernel, copies in ka.LIST_DESIGNS["paired"].items():
        assert list(copies)[0] == "stamps"
        assert kernel in ka.STAMPED_KERNELS
        for i, (copy, patches) in enumerate(copies.items()):
            out = ka.patched_csrc(csrc, str(tmp_path / f"{kernel}{i}"),
                                  patches)
            with open(os.path.join(out, "rasterize_v1.cu")) as f:
                text = f.read()
            stamped = int(copy == "stamps")
            assert text.count("GA_BEGIN();") == stamped, (kernel, copy)
            assert text.count("GA_END();") == stamped, (kernel, copy)
            assert text.count('extern "C" int ga_occupancy(') == stamped
            assert text.count("ga_stamps") == stamped


def test_attribution_copies_leave_the_wrappers_sources():
    """After a measurement's copies the wrappers build from their own
    sources again, so one run can take the training and the list cases in
    turn (the second once read the first's deleted copy)."""
    from gaussiananything_tpu_torch.tools import kernel_attribution as ka
    before = (dict(rasterize_cuda.SOURCES), list(rasterize_cuda.HEADERS),
              rasterize_cuda.BUILD_DIR)
    csrc = os.path.dirname(rasterize_cuda.SOURCES["v1"])
    with ka._copies(rasterize_cuda) as tmp:
        ka._use(rasterize_cuda, ka.patched_csrc(csrc, tmp, {}))
        assert rasterize_cuda.SOURCES != before[0]
    assert (rasterize_cuda.SOURCES, rasterize_cuda.HEADERS,
            rasterize_cuda.BUILD_DIR) == before
    assert ka.design_of(csrc, ka.LIST_DESIGNS) == "paired"
