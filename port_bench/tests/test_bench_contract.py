"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""
import json
import os
import re

import pytest

from port_bench import harness

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _metrics():
    return B["end_to_end"] + B["per_layer"]


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert 1 <= len(B["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in B["end_to_end"])


def test_names_and_units():
    names = [c["name"] for c in B["configs"]] + \
        [w["name"] for w in B["workloads"]] + [m["name"] for m in _metrics()]
    names += [w["config"] for w in B["workloads"]]
    names += [w["traffic"] for w in B["workloads"]]
    names += [k for c in B["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in B[kind]}) == len(B[kind])
    assert len({m["name"] for m in _metrics()}) == len(_metrics())
    for text in [w["why"] for w in B["workloads"]] + \
            [c["source"] for c in B["configs"]] + \
            [m["layer"] for m in B["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_moves_is_reported_by_every_cell(metric):
    m = next(x for x in B["per_layer"] if x["name"] == metric)
    moved = next(x for x in B["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert _reports(cell, moved), (metric, cell)
    assert os.path.exists(harness.reader_path(metric))


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_has_its_files_and_metrics(cell):
    w = harness.workload(B, cell)
    params, config = harness.cell_files(cell, w["config"])
    assert os.path.exists(os.path.join(harness.BENCH, "drivers",
                                       f"{params['driver']}.py"))
    e2e = [m["name"] for m in B["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(cell, m) for m in B["per_layer"])
    cfg = next(c for c in B["configs"] if c["name"] == w["config"])
    assert cfg["file"].startswith("port_bench/")
    assert json.load(open(os.path.join(harness.ROOT, cfg["file"])))
    assert params["limits"]


def test_layers_are_named_in_perf_md():
    text = open(os.path.join(harness.ROOT, "PERF.md")).read()
    for m in B["per_layer"]:
        assert f"| {m['layer']} |" in text, m["layer"]
