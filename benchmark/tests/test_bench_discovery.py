"""Discovery by name: every configuration, cell and metric that
BENCHMARK.json names has its files, and a cell added as a data file alone
is found and runs."""

import json
import os
import re
import time

from conftest import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_named_file_exists():
    b = bench()
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        for kind in ("pipelines", "reference"):
            key = "pipeline" if kind == "pipelines" else "reference"
            assert os.path.exists(os.path.join(ROOT, "benchmark", kind, f"{cfg[key]}.py"))
    for w in b["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.spec["config"] == w["config"] and cell.chips == w["chips"] == 1
        assert cell.spec["why"] == w["why"] and w["name"] == f"{w['config']}.{w['traffic']}"
        assert set(cell.config["limits"]) >= {"loss_gap"}
    for m in b["end_to_end"] + b["per_layer"]:
        module = harness.load_module(harness.BENCH_DIR, "metrics", m["name"])
        assert callable(module.read)


def test_names_and_keys_keep_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] == "step_ms"
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


def test_a_dropped_cell_file_is_found_and_runs(tiny_bench):
    names = sorted(os.listdir(os.path.join(tiny_bench, "workloads")))
    assert "knn_l2.tiny.json" in names
    cell = harness.find_cell("knn_l2.tiny", tiny_bench)
    assert [m["name"] for m in cell.metrics["end_to_end"]] == [
        "step_ms", "step_p95_ms", "setup_s"]
    r = harness.run_cell(cell, 2**31 + 5, 0.2, False, device="cpu",
                         t_start=time.perf_counter(), bench_dir=tiny_bench, log=lambda s: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(cell.config["limits"])
