"""The check's control and faults at a size a test run holds: the plain
reference in TF32 in the program's place fails a limit, and a run with the
timed path broken underneath reads ``correct`` false."""

import time

import pytest

from benchmark import clouds, harness


def cell_and_modules(name, bench):
    cell = harness.find_cell(name, bench)
    pipe = harness.load_module(bench, "pipelines", cell.config["pipeline"])
    ref = harness.load_module(bench, "reference", cell.config["reference"])
    return cell, pipe, ref


@pytest.mark.parametrize("name", ["knn_l2.tiny", "chamfer_nc.tiny"])
@pytest.mark.parametrize("seed", [2**31 + 11, 3_000_000_001, 17])
def test_control_fails_a_limit(tiny_bench, name, seed):
    cell, pipe, ref = cell_and_modules(name, tiny_bench)
    dev, host = clouds.generators(seed, "cpu")
    numbers = pipe.control(pipe.make_inputs(cell.spec["traffic"], dev, host, "cpu"), ref, host)
    limits = cell.config["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def run(cell, bench, seed=2**31 + 9):
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", t_start=time.perf_counter(),
                            bench_dir=bench, log=lambda s: None)


CASES = [(cell, fault) for cell in ("knn_l2.tiny", "chamfer_nc.tiny")
         for fault in harness.load_module(harness.BENCH_DIR, "pipelines",
                                          cell.split(".")[0]).FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_reads_incorrect(tiny_bench, name, fault):
    import pytorch3d_pointops_tpu_torch as port

    cell, pipe, _ = cell_and_modules(name, tiny_bench)
    with pipe.plant(fault, port):
        broken = run(cell, tiny_bench)
    assert not broken["correct"], broken["checks"]
    sound = run(cell, tiny_bench)
    assert sound["correct"] and sound["failed"] == 0, sound["checks"]


def test_a_window_step_that_differs_counts_as_failed(tiny_bench):
    """The window holds every step to its entry's first loss."""
    import pytorch3d_pointops_tpu_torch as port

    cell, _, _ = cell_and_modules("knn_l2.tiny", tiny_bench)
    calls = {"n": 0}
    real = port.knn_points

    def drifting(*args, **kw):
        calls["n"] += 1
        out = real(*args, **kw)
        return out._replace(dists=out.dists * 1.001) if calls["n"] > 40 else out

    port.knn_points = drifting
    try:
        r = run(cell, tiny_bench)
    finally:
        port.knn_points = real
    assert r["failed"] > 0 and not r["correct"]


def test_calibrate_judges_every_reading_against_the_limits(tiny_bench):
    """calibrate.py holds each reading to the limits as a run does: the
    program's come out correct, the control's and every fault's not."""
    from benchmark import calibrate

    lines = calibrate.readings("chamfer_nc.tiny", 2, 2, 1, 0.2, "cpu",
                               bench_dir=tiny_bench, emit=lambda s: None)
    by_mode = {}
    for line in lines:
        by_mode.setdefault(line["mode"], []).append(line)
    assert all(r["correct"] and not r["failing"] for r in by_mode.pop("program"))
    assert len(by_mode) == 1 + len(harness.load_module(
        tiny_bench, "pipelines", "chamfer_nc").FAULTS)
    for rows in by_mode.values():
        assert all(not r["correct"] and r["failing"] for r in rows), rows
    summary = calibrate.summary(lines)["correct"]
    assert summary["program"] == "2 of 2" and summary["control"] == "0 of 2"
