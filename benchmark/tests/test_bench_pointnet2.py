"""The ``pointnet2_ssg`` configuration at a size a test run holds: a tiny
cell of its own (published widths, npoint and nsample; 4 clouds of 600-640
points, a pool of 2) reads ``correct``, the TF32 control fails a limit,
each planted fault reads incorrect, the comparison catches a state left
unchanged or moved the wrong way, the reference imports nothing of the
port, and ``mfu``'s and ``gather_bwd_roofline``'s counts are the published
network's."""

import importlib.util
import json
import os
import time

import pytest
import torch

from conftest import ROOT

from benchmark import clouds, harness

CELL = "pointnet2_ssg.tiny"
TINY = {"config": "pointnet2_ssg", "chips": 1, "why": "tiny", "traffic": {
    "pool": 2, "lr": 0.001,
    "clouds": {"batch": 4, "points": 640, "lengths": [640, 600, 611, 633]},
    "jitter": {"sigma": 0.01, "clip": 0.05}}}


@pytest.fixture
def bench(tiny_bench):
    with open(os.path.join(tiny_bench, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(TINY, f)
    return tiny_bench


def modules(bench):
    cell = harness.find_cell(CELL, bench)
    pipe = harness.load_module(bench, "pipelines", cell.config["pipeline"])
    ref = harness.load_module(bench, "reference", cell.config["reference"])
    return cell, pipe, ref


def run(cell, bench, seed=2**31 + 9):
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", t_start=time.perf_counter(),
                            bench_dir=bench, log=lambda s: None)


def test_the_tiny_cell_reads_correct(bench):
    cell, _, _ = modules(bench)
    r = run(cell, bench)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == set(cell.config["limits"])
    assert r["checks"]["plan_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"step_ms", "setup_s"}


def test_the_control_fails_a_limit(bench):
    cell, pipe, ref = modules(bench)
    dev, host = clouds.generators(3_000_000_001, "cpu")
    numbers = pipe.control(pipe.make_inputs(cell.spec["traffic"], dev, host, "cpu"), ref, host)
    limits = cell.config["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer", "half_batch"])
def test_a_planted_fault_reads_incorrect(bench, fault):
    import pytorch3d_pointops_tpu_torch as port

    cell, pipe, _ = modules(bench)
    assert fault in pipe.FAULTS
    with pipe.plant(fault, port):
        broken = run(cell, bench)
    assert not broken["correct"], broken["checks"]


def test_a_state_left_unchanged_or_reversed_reads_over_its_limit(bench):
    """Held against the reference's own first step: one small parameter
    left where it was (the head's last bias, 40 of the network's entries),
    every update reversed, and one batch norm's running statistics left
    unchanged each fail a limit; the reference against itself reads 0."""
    cell, pipe, ref = modules(bench)
    dev, host = clouds.generators(3_000_000_003, "cpu")
    inputs = pipe.make_inputs(cell.spec["traffic"], dev, host, "cpu")
    want, exact = ref.first_step(inputs), ref.exact_gradient(inputs)
    limits = cell.config["limits"]

    def read(**change):
        got = dict(want, grad=want["grads"], change=dict(want["change"], **change))
        return pipe.compare(got, want, exact)

    same = read()
    assert all(v == 0 for v in same.values()), same
    frozen = read(**{"fc3.bias": 0 * want["change"]["fc3.bias"]})
    assert frozen["update_gap"] == 1.0 > limits["update_gap"]
    reversed_ = read(**{n: -c for n, c in want["change"].items() if n in exact})
    assert reversed_["update_gap"] == 2.0
    stale = read(**{"sa2.norms.1.running_var": 0 * want["change"]["sa2.norms.1.running_var"]})
    assert stale["stats_gap"] == 1.0 > limits["stats_gap"]


def test_the_reference_imports_nothing_of_the_port():
    path = os.path.join(harness.BENCH_DIR, "reference", "pointnet2_ssg.py")
    src = open(path).read()
    assert "pytorch3d_pointops_tpu" not in src and "jax" not in src
    imports = {line for line in src.splitlines() if line.startswith(("import ", "from "))}
    assert imports == {"from __future__ import annotations", "import torch",
                       "import torch.nn.functional as F"}


def test_mfu_counts_the_published_network():
    """26.8 G multiply-adds forward at B = 32 (SA1 524,288 positions x
    12,480, SA2 262,144 x 65,920, SA3 4,096 x 721,664, the head 32 x
    665,600); the backward twice that less SA1's first input gradient
    (524,288 x 3 x 64): 160.6 GFLOP."""
    spec = importlib.util.spec_from_file_location(
        "p", os.path.join(harness.BENCH_DIR, "pipelines", "pointnet2_ssg.py"))
    pipe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pipe)
    forward = 524_288 * 12_480 + 262_144 * 65_920 + 4_096 * 721_664 + 32 * 665_600
    assert forward == 26_800_881_664
    flops = pipe.dense_flops(32)
    assert flops == 2 * (3 * forward - 524_288 * 3 * 64)
    assert round(flops / 1e9, 1) == 160.6
    mfu = harness.load_module(harness.BENCH_DIR, "metrics", "mfu")
    ctx = harness.Ctx(work={"dense": {"span": "step", "ops": flops, "bytes": 0}},
                      peak=(67e12, 3.35e12), step_s=[0.008, 0.0079, 0.0081])
    assert mfu.read(ctx) == pytest.approx(100 * flops / (67e12 * 0.008))
    assert mfu.read(harness.Ctx(step_s=[0.008])) is None
    with open(os.path.join(ROOT, "benchmark", "workloads", "pointnet2_ssg.b32x4k.json")) as f:
        traffic = json.load(f)["traffic"]
    lengths = traffic["clouds"]["lengths"]
    assert len(lengths) == 32 and 3500 <= min(lengths) and max(lengths) <= 4096


def test_the_scatter_roofline_reads_the_scatter_kernels_alone():
    """262,144 entries of 128 channels into 16,384 rows at B = 32: the
    contributions and indices read, the rows written, over the device time
    of the scatter's kernels in ``port.bwd``, and nothing else's."""
    from benchmark import trace, work

    spec = importlib.util.spec_from_file_location(
        "p", os.path.join(harness.BENCH_DIR, "pipelines", "pointnet2_ssg.py"))
    pipe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pipe)
    counts = pipe.work_counts({"clouds": [{"xyz": torch.zeros(32, 1, 3)}]}, {})["gather_bwd"]
    assert counts["ops"] == 262_144 * 128
    assert counts["bytes"] == 4 * 128 * (262_144 + 16_384) + 8 * 262_144
    acts = [trace.Activity("radix_histogram", 0, 10, "port.bwd"),
            trace.Activity("radix_onesweep<true, 10>", 10, 20, "port.bwd"),
            trace.Activity("bucket_sum_kernel<false, 128>", 30, 70, "port.bwd"),
            trace.Activity("sm80_xmma_gemm_f32f32", 100, 500, "port.bwd"),
            trace.Activity("bucket_sum_kernel<false, 3>", 600, 50, "port.fwd")]
    reader = harness.load_module(harness.BENCH_DIR, "metrics", "gather_bwd_roofline")
    ctx = harness.Ctx(work={"gather_bwd": counts}, trace=trace.Trace(activities=acts),
                      profiled_steps=2, peak=(67e12, 3.35e12))
    least = work.least_s(counts["ops"], counts["bytes"], ctx.peak)
    assert reader.read(ctx) == pytest.approx(100 * least / (100e-6 / 2))
    ctx.trace = trace.Trace(activities=acts[3:])
    assert reader.read(ctx) is None


def test_the_plan_readers_read_none_without_their_spans():
    ctx = harness.Ctx()
    for name in ("pointnet2.plan_ms", "pointnet2.plan_idle_ms", "gather_bwd_roofline"):
        assert harness.load_module(harness.BENCH_DIR, "metrics", name).read(ctx) is None
