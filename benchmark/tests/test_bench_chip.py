"""On a card: a traced run attributes every device activity to the span
that launched it. Skips without a CUDA card."""

import time

import pytest
import torch

from benchmark import harness


@pytest.mark.chip
@pytest.mark.parametrize("name", ["knn_l2.tiny", "chamfer_nc.tiny"])
def test_traced_run_attributes_every_activity(tiny_bench, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.find_cell(name, tiny_bench)
    lines = []
    r = harness.run_cell(cell, 5, 0.5, True, device=torch.device("cuda", 0),
                         t_start=time.perf_counter(), bench_dir=tiny_bench, log=lines.append)
    assert r["correct"]
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert any(" 0 not attributed" in line for line in lines), lines
    assert r["metrics"]["ops.launches"]["value"] > 0
