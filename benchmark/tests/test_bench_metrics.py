"""The metric arithmetic on synthetic steps, spans and device events."""

import statistics

import pytest

from benchmark import harness, trace, work


def metric(name, ctx):
    return harness.load_module(harness.BENCH_DIR, "metrics", name).read(ctx)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic_trace():
    """Two steps of 100 us. Step 1: the forward span (0-30) launches kernels
    a (correlation 1) and b (2); the backward span (30-60) launches c (3).
    The device runs a 10-30, b 25-45 (overlapping a), c 60-70. Step 2
    (100-200): forward launches d (4), running 150-190."""
    return [
        ev("user_annotation", "bench.step", 0, 100),
        ev("user_annotation", "bench.port.fwd", 0, 30),
        ev("user_annotation", "bench.port.bwd", 30, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=2),
        ev("cuda_driver", "cuLaunchKernel", 35, 1, correlation=3),
        ev("kernel", "void a<1>(int)", 10, 20, correlation=1),
        ev("kernel", "void a<1>(int)", 25, 20, correlation=2),
        ev("gpu_memset", "Memset (Device)", 60, 10, correlation=3),
        ev("user_annotation", "bench.step", 100, 100),
        ev("user_annotation", "bench.port.fwd", 100, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=4),
        ev("kernel", "d", 150, 40, correlation=4),
        ev("kernel", "lost", 195, 1, correlation=99),
        {"ph": "M", "name": "process_name"},
    ]


def test_reduce_attributes_each_activity_to_its_launching_span():
    tr = trace.reduce_events(synthetic_trace())
    assert [a.span for a in tr.activities] == ["port.fwd", "port.fwd", "port.bwd",
                                              "port.fwd", trace.OUTSIDE]
    assert tr.unattributed == 1 and tr.steps == [(0.0, 100.0), (100.0, 200.0)]
    assert trace.span_device_us(tr, "port.fwd") == 20 + 20 + 40
    assert trace.span_device_us(tr, "port.bwd") == 10
    # union: 10-45 (35), 60-70 (10), 150-190 (40), 195-196 (1)
    assert trace.busy_us(tr) == 86
    idle = trace.idle_by_span(tr)
    # gaps 0-10 (fwd), 45-60 (bwd), 70-150 (from 70: outside spans until 100,
    # labelled by where it began), 190-195 and 196-200 (fwd of step 2 ended
    # at 150: outside)
    assert idle == {"port.fwd": 10, "port.bwd": 15, trace.OUTSIDE: 80 + 5 + 4}
    assert sum(idle.values()) + trace.busy_us(tr) == 200


def ctx_with_trace(**kw):
    tr = trace.reduce_events(synthetic_trace())
    return harness.Ctx(trace=tr, profiled_steps=2, **kw)


def test_end_to_end_metrics():
    step_s = [0.001 * (1 + k / 100) for k in range(100)]
    ctx = harness.Ctx(setup_s=7.5, window_s=0.2, step_s=step_s)
    assert metric("step_ms", ctx) == pytest.approx(1e3 * 0.2 / 100)
    # inclusive 95th percentile of 1.00 .. 1.99 ms: 1.9405 ms
    assert metric("step_p95_ms", ctx) == pytest.approx(1.9405)
    assert metric("step_p95_ms", ctx) == pytest.approx(
        1e3 * statistics.quantiles(step_s, n=20, method="inclusive")[18])
    assert metric("setup_s", ctx) == 7.5


def test_device_metrics():
    ctx = ctx_with_trace(step_s=[0.0002, 0.0002])
    assert metric("ops.launches", ctx) == 5 / 2
    assert metric("device.busy_ms", ctx) == pytest.approx(86 / 1e3 / 2)
    # busy 0.043 ms a step against unprofiled steps of 0.2 ms
    assert metric("device.idle_share", ctx) == pytest.approx(100 * (1 - 0.043 / 0.2))
    assert metric("device.busy_ms", harness.Ctx()) is None
    assert metric("device.idle_share", harness.Ctx()) is None


def test_issue_ms_ends_at_the_last_port_span():
    spans = [[("port.fwd", 0.0, 0.001), ("user.loss", 0.001, 0.0012),
              ("port.bwd", 0.0012, 0.003), ("read", 0.003, 0.005)],
             [("port.fwd", 0.0, 0.002), ("port.bwd", 0.002, 0.004), ("read", 0.004, 0.006)]]
    assert metric("ops.issue_ms", harness.Ctx(spans=spans)) == pytest.approx(3.5)
    assert metric("ops.issue_ms", harness.Ctx()) is None


def test_span_rooflines():
    peak = (1e12, 1e11)
    ctx = ctx_with_trace(peak=peak, work={
        "knn_fwd": {"span": "port.fwd", "ops": 4e4, "bytes": 1e6},
        "bwd": {"span": "port.bwd", "ops": 1.0, "bytes": 1e5}})
    # fwd: least max(4e-8, 1e-5) = 1e-5 s over 40 us a step -> 25 %
    assert metric("knn_fwd_roofline", ctx) == pytest.approx(25.0)
    # bwd: least 1e-6 s over 5 us a step -> 20 %
    assert metric("bwd_roofline", ctx) == pytest.approx(20.0)
    assert metric("chamfer_fwd_roofline", ctx) is None
    ctx.peak = None
    assert metric("knn_fwd_roofline", ctx) is None


def test_breakdown_names_and_orders():
    b = harness.breakdown(trace.reduce_events(synthetic_trace()))
    assert b["device_ops"][0] == ["a<1>", pytest.approx(40e-6)]
    assert [k for k, _ in b["device_ops"]] == ["a<1>", "d", "Memset (Device)", "lost"]
    assert b["idle_gaps"][0] == [f"host in {trace.OUTSIDE}", pytest.approx(89e-6)]


def test_peaks_table():
    assert work.peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert work.peaks("cpu") is None
