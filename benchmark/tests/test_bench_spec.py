"""BENCHMARK.json against the benchmark's contract: names, units, files,
and which cell reports what."""
import json
import os
import re

import pytest

from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]] \
        + [w["name"] for w in spec["workloads"]] \
        + [w["config"] for w in spec["workloads"]] \
        + [w["traffic"] for w in spec["workloads"]] \
        + [k for c in spec["configs"] for k in c["reduced"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for text in [c["source"] for c in spec["configs"]] \
            + [c["why"] for c in spec["configs"] + spec["workloads"]] \
            + [m["layer"] for m in spec["per_layer"]] + spec["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_files_exist(spec):
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        for kind, name in (("configs", w["config"]),
                           ("traffic", w["traffic"])):
            assert os.path.isfile(os.path.join(REPO, "benchmark", kind,
                                               name + ".json"))
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.isfile(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py")), m["name"]


def test_bounds(spec):
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in spec["end_to_end"])


def test_each_cell_reports(spec):
    def of(m, cell):
        return cell in m.get("workloads", [cell])
    for w in spec["workloads"]:
        e2e = [m["name"] for m in spec["end_to_end"] if of(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(of(m, w["name"]) for m in spec["per_layer"])


def test_moves_is_reported_by_each_cell(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in target.get("workloads", [cell]), (m["name"], cell)


def test_one_layer_name_per_layer(spec):
    layers = {m["layer"] for m in spec["per_layer"]}
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert layer in perf, layer
