"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added as data files only.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``chip`` need a CUDA card and skip without one.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "knn_l2.tiny": {"config": "knn_l2", "chips": 1, "why": "tiny", "traffic": {
        "pool": 4, "K": 4, "check_entries": 2,
        "queries": {"batch": 2, "points": 64, "lengths": [64, 50]},
        "points": {"batch": 2, "points": 80, "lengths": [80, 70]}}},
    "chamfer_nc.tiny": {"config": "chamfer_nc", "chips": 1, "why": "tiny", "traffic": {
        "pool": 4, "lr_per_point": 0.2,
        "source": {"batch": 2, "points": 60, "lengths": [52, 60], "scale": 1.5},
        "target": {"batch": 2, "points": 60, "lengths": [60, 41]},
        "features": {"normals": "unit_gaussian", "colors": "uniform"}}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` in which the tiny
    cells exist as workload files and report every metric; returns the
    copy's ``benchmark`` directory."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, spec in TINY.items():
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            configs = {cell.split(".")[0] for cell in m["workloads"]}
            m["workloads"] += [n for n in TINY if n.split(".")[0] in configs]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(bench)
