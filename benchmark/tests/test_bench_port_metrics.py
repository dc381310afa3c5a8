"""The readers of the port's own spans (``ops.host_syncs``,
``knn.fwd_idle_ms``, ``ops.bwd_idle_ms``) on a synthetic traced step and
synthetic span records of the port."""

import threading

import pytest

from benchmark import harness, port_records, port_spans, trace
from pytorch3d_pointops_tpu_torch import tracing

# A base time of the profiler's Chrome export, and a thread of the autograd
# engine's.
BASE = tracing.trace_base_ns(1_790_000_000)
OTHER_THREAD = -1


def metric(name, ctx):
    return harness.load_module(harness.BENCH_DIR, "metrics", name).read(ctx)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic_ctx(steps=1):
    """One step of 100 us: the bench spans port.fwd 0-40, port.bwd 40-70 and
    read 70-100; kernel a (launched at 10 in port.fwd) runs 20-35, kernel b
    (launched at 50 in port.bwd) 55-62. The device idles 0-20, 35-55 and
    62-100."""
    events = [
        ev("user_annotation", "bench.step", 0, 100),
        ev("user_annotation", "bench.port.fwd", 0, 40),
        ev("user_annotation", "bench.port.bwd", 40, 30),
        ev("user_annotation", "bench.read", 70, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
        ev("kernel", "a", 20, 15, correlation=1),
        ev("kernel", "b", 55, 7, correlation=2),
    ]
    return harness.Ctx(trace=trace.reduce_events(events), profiled_steps=steps)


def rec(id_, name, parent, start_us, end_us, thread=None, counts=None, shift_ns=0):
    return tracing.Record(
        id_, name, parent, threading.main_thread().ident if thread is None else thread,
        BASE + int(start_us * 1000) + shift_ns, BASE + int(end_us * 1000) + shift_ns,
        counts or {})


def synthetic_records(shift_ns=0):
    """The port's spans of that step: knn_points 2-38 > knn_topk 5-30 >
    knn.rounds 6-28 on the main thread, with 2 syncs in knn_points itself;
    KnnPoints.bwd 45-65 > scatter 50-60 on the engine's thread."""
    return [
        rec(2, "knn.rounds", 1, 6, 28, shift_ns=shift_ns),
        rec(1, "knn_topk", 0, 5, 30, shift_ns=shift_ns),
        rec(0, "knn_points", None, 2, 38, counts={"sync.x": 2}, shift_ns=shift_ns),
        rec(4, "scatter", 3, 50, 60, OTHER_THREAD, {"launch.scatter_add_rows": 1},
            shift_ns=shift_ns),
        rec(3, "KnnPoints.bwd", None, 45, 65, OTHER_THREAD, shift_ns=shift_ns),
    ]


@pytest.fixture
def records(monkeypatch):
    """Set the port's records to the list this returns."""
    held = []
    monkeypatch.setattr(tracing, "records", lambda: list(held))
    return held


def test_readers_on_a_synthetic_step(records):
    records.extend(synthetic_records())
    ctx = synthetic_ctx()
    assert metric("ops.host_syncs", ctx) == 2
    # The gap 35-55 begins inside knn_points; 62-100 inside KnnPoints.bwd;
    # 0-20 outside every port span.
    assert metric("knn.fwd_idle_ms", ctx) == pytest.approx(20 / 1e3)
    assert metric("ops.bwd_idle_ms", ctx) == pytest.approx(38 / 1e3)
    ctx.profiled_steps = 2
    assert metric("ops.host_syncs", ctx) == 1
    assert metric("knn.fwd_idle_ms", ctx) == pytest.approx(10 / 1e3)
    assert metric("ops.bwd_idle_ms", ctx) == pytest.approx(19 / 1e3)


def test_mapping_onto_the_trace(records):
    records.extend(synthetic_records())
    got = {r.name: (s, e) for r, s, e in port_records.mapped(synthetic_ctx())}
    assert got["knn_points"] == pytest.approx((2.0, 38.0))
    assert got["scatter"] == pytest.approx((50.0, 60.0))
    assert port_records.with_descendants(
        [r for r in records], [r for r in records if r.name == "knn_points"]) == {0, 1, 2}


def test_nothing_to_read_reads_none(records, monkeypatch):
    ctx = synthetic_ctx()
    names = ("ops.host_syncs", "knn.fwd_idle_ms", "ops.bwd_idle_ms")
    assert [metric(n, ctx) for n in names] == [None] * 3  # no record
    records.extend(synthetic_records())
    assert [metric(n, harness.Ctx()) for n in names] == [None] * 3  # no trace
    # A port from before ``tracing``: nothing to import.
    monkeypatch.setattr(port_records, "_tracing", lambda: None)
    assert [metric(n, ctx) for n in names] == [None] * 3


@pytest.mark.parametrize("shift_ns", [-50_000, 100_000, 10**9,
                                      tracing.TRACE_BASE_SECONDS * 10**9 // 2])
def test_a_clock_that_fails_the_check_reads_none(records, shift_ns):
    """Entry spans moved off the bench port.* spans, by tens of us or by a
    base that is not the export's, read nothing."""
    records.extend(synthetic_records(shift_ns))
    ctx = synthetic_ctx()
    for name in ("ops.host_syncs", "knn.fwd_idle_ms", "ops.bwd_idle_ms"):
        assert metric(name, ctx) is None


def test_a_reader_without_its_spans_reads_none(records):
    records.extend(r for r in synthetic_records() if r.thread != OTHER_THREAD)
    ctx = synthetic_ctx()
    assert metric("ops.bwd_idle_ms", ctx) is None  # no backward span
    assert metric("knn.fwd_idle_ms", ctx) == pytest.approx(20 / 1e3)
    records[:] = [rec(0, "update_padded", None, 2, 38, counts={"sync.y": 1})]
    assert metric("knn.fwd_idle_ms", ctx) is None  # no knn_points
    assert metric("ops.host_syncs", ctx) == 1


def test_self_times_subtract_the_spans_opened_inside():
    recs = synthetic_records()
    got = port_spans.self_times(recs, steps=2)
    # knn_points 36 us holds knn_topk 25 us, which holds knn.rounds 22 us.
    assert got["knn_points"]["wall_ms"] == pytest.approx(36e-3 / 2)
    assert got["knn_points"]["self_ms"] == pytest.approx(11e-3 / 2)
    assert got["knn_topk"]["self_ms"] == pytest.approx(3e-3 / 2)
    assert got["knn.rounds"]["self_ms"] == pytest.approx(22e-3 / 2)
    assert got["KnnPoints.bwd"]["self_ms"] == pytest.approx(10e-3 / 2)
    assert got["knn_points"]["calls"] == 0.5
    assert got["knn_points"]["counts"] == {"sync.x": 1.0}
    assert got["scatter"]["counts"] == {"launch.scatter_add_rows": 0.5}


def test_a_clock_within_the_slack_reads(records):
    """An entry span past its bench span by less than ``SLACK_US`` (the
    profiler's conversion of its clock) still reads."""
    shift_us = port_records.SLACK_US / 2
    records.extend(synthetic_records(int(shift_us * 1000)))
    assert metric("ops.host_syncs", synthetic_ctx()) == 2
