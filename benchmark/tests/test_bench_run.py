"""A whole run of each traffic mix at tiny widths on the CPU (the run's
look for a card skipped), the result line, the no-JAX check, and a cell,
configuration, traffic mix and metric added as new files only."""
import json
import os
import sys
import types

import pytest
import torch

from benchmark import core, run
from benchmark.tests.tiny import checkout

SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return checkout(str(tmp_path_factory.mktemp("bench")))


def _line(rec, metrics, traced):
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 1}
    if traced:
        device.update(busy_s=rec["trace"].get("busy_s", 0.0),
                      window_s=rec["trace"].get("window_s", 0.0))
    return core.result(rec, metrics, device, traced)


# on the CPU nothing reads device memory, the card's trace or its kernels
CARD_ONLY = {"peak_gib", "k1_roofline", "idle_share.request", "k2_roofline",
             "idle_share.train"}


@pytest.mark.parametrize("cell,trace", [("i23d-release.image", 0),
                                        ("i23d-release.image", 1),
                                        ("vae-release.train", 0),
                                        ("vae-release.train", 1)])
def test_cell_tiny(root, cell, trace, capsys):
    rec, metrics = run.run_cell(root, cell, SEED, 0.2, bool(trace),
                                device="cpu")
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] >= 2
    names = {m["name"] for m in core.cell_metrics(
        core.load_spec(root), cell, bool(trace))}
    expect = names - CARD_ONLY
    assert expect <= set(metrics), (expect, metrics)
    out = _line(rec, metrics, bool(trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"] \
        + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    core.emit(out)
    cap = capsys.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    err = cap.err.strip().splitlines()
    assert all(line.startswith("check ") and "limit" in line
               for line in err[-len(out["checks"]):])


def test_no_jax_compares_whole_names(monkeypatch):
    assert core.jax_modules() == []
    for name in ("gaussiananything_tpu_torch.x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.jax_modules() == []
    monkeypatch.setitem(sys.modules, "gaussiananything_tpu.ops",
                        types.ModuleType("gaussiananything_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert core.jax_modules() == ["gaussiananything_tpu", "jax"]


def test_a_run_imports_no_jax(root):
    run.run_cell(root, "i23d-release.image", SEED + 1, 0.05, False,
                 device="cpu")
    assert core.jax_modules() == []


def test_new_cell_from_new_files_only(root, tmp_path):
    """A configuration, a traffic mix, a metric and a cell, each a new
    file or entry: no file the benchmark has is edited."""
    before = {p: open(p, "rb").read() for p in _files(root)}
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "i23d-release.json")) as f:
        cfg = json.load(f)
    cfg["sampler"]["cfg_scale"] = 3.0
    with open(os.path.join(bench, "configs", "dummy-config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "i23d-release.image.json")) as f:
        traffic = json.load(f)
    traffic["image_pool"] = 3
    with open(os.path.join(bench, "traffic", "dummy-traffic.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "metrics", "dummy_count.py"), "w") as f:
        f.write("def read(rec):\n    return float(len(rec['latencies']))\n")
    spec = core.load_spec(root)
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                              "traffic": "dummy-traffic", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "dummy_count", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "Test", "moves": "request_s",
                              "workloads": ["dummy.cell"]})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dummy.cell")
    other = str(tmp_path / "c")
    os.makedirs(other)
    os.symlink(bench, os.path.join(other, "benchmark"))
    with open(os.path.join(other, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    rec, metrics = run.run_cell(other, "dummy.cell", SEED, 0.05, True,
                                device="cpu")
    assert metrics["dummy_count"]["value"] == rec["attempted"]
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _files(root):
    for d, _, fs in os.walk(os.path.join(root, "benchmark")):
        for f in fs:
            yield os.path.join(d, f)
