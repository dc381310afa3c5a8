"""No run loads JAX or the JAX package: the check compares whole
top-level names, and a CPU run of a tiny cell through everything a run
imports leaves none of them in ``sys.modules``."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

from benchmark import harness

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark import harness
for name in ("knn_l2.tiny", "chamfer_nc.tiny"):
    cell = harness.find_cell(name, {bench!r})
    r = harness.run_cell(cell, 7, 0.1, True, device="cpu", t_start=time.perf_counter(),
                         bench_dir={bench!r}, log=lambda s: None)
    assert r["correct"], r
print(json.dumps(harness.forbidden_modules(sys.modules)))
print(json.dumps(sorted(m for m in sys.modules if m.startswith("pytorch3d_pointops_tpu"))))
"""


def test_forbidden_names_compare_whole():
    mods = ["jax.numpy", "pytorch3d_pointops_tpu_torch.ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == ["jax"]
    assert harness.forbidden_modules(["pytorch3d_pointops_tpu.ops.knn", "flax"]) == [
        "flax", "pytorch3d_pointops_tpu"]
    assert harness.forbidden_modules(["pytorch3d_pointops_tpu_torch"]) == []


def test_a_run_loads_no_jax(tiny_bench):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", RUN.format(root=ROOT, bench=tiny_bench)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    found, port = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert found == []
    assert "pytorch3d_pointops_tpu_torch" in port


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    """No CUDA card here: exit 3 and no result. In a directory holding only
    BENCHMARK.json and the benchmark, no result either."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "knn_l2.p100k_k16",
             "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0 and out.stdout == ""
