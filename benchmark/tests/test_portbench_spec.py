"""BENCHMARK.json against its contract, and every cell resolved to its
configuration, traffic, driver, limits and metric files."""

import json
import os
import re

import pytest

import harness

B = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_resolves(cell):
    c = harness.Cell(B, cell)
    assert os.path.exists(c.driver_path)
    assert os.path.exists(os.path.join(harness.BENCH, "limits",
                                       cell + ".json"))
    assert c.chips == 1
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert os.path.exists(os.path.join(harness.BENCH, "layer_metrics",
                                           m["name"] + ".py"))
        assert hasattr(c.metric_reader(m), "read")
    for key in c.config_entry["reduced"]:
        assert key in c.config


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in B["configs"]}
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"] + B["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in B["workloads"]}
    for m in B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in B["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert json.load(open(os.path.join(harness.ROOT, c["file"])))
