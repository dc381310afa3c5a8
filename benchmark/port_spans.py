"""Where the port keeps the host in a cell's step, read from the port's own
spans and counters (``pytorch3d_pointops_tpu_torch.tracing``), on a card.

    python3 benchmark/port_spans.py --workload <cell> [--seed N] [--steps 200]
        [--blocks 6] [--block-steps 100] [--out FILE]

In one process, after the set-up a run makes (the first pass and the warm
pass over the pool), four readings, each one JSON line on standard output
(and appended to ``--out``):

- ``syncs``: one step with ``torch.cuda.set_sync_debug_mode("warn")`` on
  inside the step's ``port.*`` spans alone: the synchronizing operations it
  warns of, beside the port's ``sync.*`` counts over the same step;
- ``cost``: steps with ``tracing.recording()`` off and on, in alternating
  blocks of ``--block-steps``: the mean and median step of each;
- ``self``: ``--steps`` steps under ``recording()``, without the profiler:
  for each port span, its calls, its wall time and its self time (its time
  less that of the spans opened inside it) a step, in ms, and its counts;
- ``idle``: ``harness.PROFILED_STEPS`` steps under ``torch.profiler``, as a
  ``--trace 1`` run profiles them: device idle a step in the gaps that begin
  in each innermost port span and in each ``bench`` span, the profiled
  window, and the three readers of the port's spans.

Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3_000_000_041
PORT_METRICS = ("ops.host_syncs", "knn.fwd_idle_ms", "ops.bwd_idle_ms")
# What the sync debug mode warns at each synchronizing operation (it also
# warns once, when turned on, that it is a prototype).
SYNC_WARNING = "called a synchronizing CUDA operation"


class Cell:
    """A cell's step after set-up; ``run(span)`` makes the next step."""

    def __init__(self, name: str, seed: int, device, bench_dir=None):
        import pytorch3d_pointops_tpu_torch as port
        from benchmark import clouds, harness, trace

        self.bench_dir = bench_dir or harness.BENCH_DIR
        self.device = device
        cell = harness.find_cell(name, self.bench_dir)
        pipe = harness.load_module(self.bench_dir, "pipelines", cell.config["pipeline"])
        dev_gen, host_gen = clouds.generators(seed, device)
        inputs = pipe.make_inputs(cell.spec["traffic"], dev_gen, host_gen, device)
        self.step = pipe.Step(port, inputs, cell.config["options"])
        self.j = 0
        for _ in range(self.step.entries * (1 + harness.WARM_PASSES)):
            self.run(trace.no_span)
        self.sync()

    def run(self, span) -> float:
        value = self.step(self.j, span)
        self.j += 1
        return value

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def syncs(cell: Cell) -> dict:
    """One step with the sync debug mode on inside its ``port.*`` spans."""
    import torch

    from pytorch3d_pointops_tpu_torch import tracing

    @contextlib.contextmanager
    def span(name):
        if not name.startswith("port."):
            yield
            return
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    before = tracing.counts("sync.")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cell.run(span)
    cell.sync()
    after = tracing.counts("sync.")
    counted = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    warned = [str(w.message).splitlines()[0] for w in caught
              if SYNC_WARNING in str(w.message)]
    return {"warned": len(warned), "counted": sum(counted.values()),
            "sites": counted, "warnings": warned}


def cost(cell: Cell, blocks: int, block_steps: int) -> dict:
    """Step times with ``recording()`` off and on, in alternating blocks."""
    from benchmark import trace
    from pytorch3d_pointops_tpu_torch import tracing

    times = {"off": [], "on": []}
    for b in range(blocks):
        for mode in (("off", "on") if b % 2 == 0 else ("on", "off")):
            with tracing.recording() if mode == "on" else contextlib.nullcontext():
                for _ in range(block_steps):
                    t0 = time.perf_counter()
                    cell.run(trace.no_span)
                    times[mode].append(time.perf_counter() - t0)
            tracing.clear()
    return {mode: {"mean_ms": 1e3 * statistics.fmean(ts),
                   "median_ms": 1e3 * statistics.median(ts), "steps": len(ts)}
            for mode, ts in times.items()}


def self_times(records, steps: int) -> dict:
    """Per span name: calls, wall ms and self ms a step, and its counts a
    step. Self time is a span's time less that of the spans opened in it."""
    child_ns: dict = {}
    for r in records:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + (r.end_ns - r.start_ns)
    out: dict = {}
    for r in records:
        o = out.setdefault(r.name, {"calls": 0, "wall_ms": 0.0, "self_ms": 0.0, "counts": {}})
        wall = r.end_ns - r.start_ns
        o["calls"] += 1
        o["wall_ms"] += wall / 1e6
        o["self_ms"] += (wall - child_ns.get(r.id, 0)) / 1e6
        for k, n in r.counts.items():
            o["counts"][k] = o["counts"].get(k, 0) + n
    for o in out.values():
        o["calls"] /= steps
        o["wall_ms"] /= steps
        o["self_ms"] /= steps
        o["counts"] = {k: n / steps for k, n in o["counts"].items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["self_ms"]))


def self_reading(cell: Cell, steps: int) -> dict:
    from benchmark import trace
    from pytorch3d_pointops_tpu_torch import tracing

    tracing.clear()
    t0 = time.perf_counter()
    with tracing.recording():
        for _ in range(steps):
            cell.run(trace.no_span)
    wall = time.perf_counter() - t0
    records = tracing.records()
    tracing.clear()
    return {"steps": steps, "step_ms": 1e3 * wall / steps, "spans": self_times(records, steps)}


def idle(cell: Cell) -> dict:
    """Profiled steps as a ``--trace 1`` run makes them, read by span."""
    from benchmark import harness, port_records, trace
    from pytorch3d_pointops_tpu_torch import tracing

    tracing.clear()
    window = {}

    def profiled():
        from torch.profiler import record_function

        spans = trace.Spans(profiled=True)
        t0 = time.perf_counter()
        for _ in range(harness.PROFILED_STEPS):
            with record_function(trace.PREFIX + "step"):
                cell.run(spans)
        window["s"] = time.perf_counter() - t0

    ctx = harness.Ctx(trace=trace.profiled(profiled), profiled_steps=harness.PROFILED_STEPS)
    cell.sync()
    steps = ctx.profiled_steps
    recs = port_records.mapped(ctx)
    by_port = None
    if recs is not None:
        tr = trace.Trace(activities=ctx.trace.activities, steps=ctx.trace.steps,
                         host_spans=[(r.name, s, e) for r, s, e in recs])
        by_port = {k: v / 1e3 / steps for k, v in sorted(
            trace.idle_by_span(tr).items(), key=lambda kv: -kv[1])}
    by_bench = {k: v / 1e3 / steps for k, v in sorted(
        trace.idle_by_span(ctx.trace).items(), key=lambda kv: -kv[1])}
    metrics = {name: harness.load_module(cell.bench_dir, "metrics", name).read(ctx)
               for name in PORT_METRICS}
    return {"window_s": window["s"], "busy_ms": trace.busy_us(ctx.trace) / 1e3 / steps,
            "activities": len(ctx.trace.activities) / steps,
            "clock_check": recs is not None, "idle_ms_by_port_span": by_port,
            "idle_ms_by_bench_span": by_bench, "metrics": metrics,
            "records": len(tracing.records()), "dropped": tracing.dropped()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--block-steps", type=int, default=100)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("port_spans: no CUDA card", file=sys.stderr)
        return 3
    sink = open(args.out, "a") if args.out else None
    try:
        def emit(kind, value):
            line = json.dumps({"cell": args.workload, "seed": args.seed, kind: value,
                               "card": torch.cuda.get_device_name(0)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()

        cell = Cell(args.workload, args.seed, torch.device("cuda", 0))
        emit("syncs", syncs(cell))
        emit("cost", cost(cell, args.blocks, args.block_steps))
        emit("self", self_reading(cell, args.steps))
        emit("idle", idle(cell))
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
