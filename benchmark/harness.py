"""One run of one cell: set-up, the measured window, the traced steps, the
check against the plain reference, and the result line.

Everything is found by name. ``BENCHMARK.json`` (beside this folder) lists
the metrics; a cell is ``workloads/<cell>.json`` (its configuration, its
traffic, its chips); a configuration is ``configs/<config>.json`` (its
pipeline, its reference, the options of its entry points and the limit of
each compared number); ``pipelines/<pipeline>.py`` makes the inputs and the
step; ``reference/<reference>.py`` is the plain reference; every metric is
``metrics/<metric>.py`` with a ``read(ctx)`` that returns a number or None.

A step of a pipeline is ``step(j, span)``: the j-th step of the loop, which
ends with the loss read to the host and returns it. Steps cycle through a
pool of ``step.entries`` input sets, so step j does the work of entry
``j % step.entries`` and reads the same loss, bit for bit, as every other
step of that entry: the first pass (set-up) records each entry's loss, and a
window step that reads another is counted in ``failed``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import time
from dataclasses import dataclass, field

import torch

from . import clouds, trace, work

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Top-level module names no run may load: JAX, its libraries, and the JAX
# package the port was made from (compared whole, since the port's own name
# begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch3d_pointops_tpu")
PROFILED_STEPS = 24  # steps under the profiler in a --trace 1 run, after warm-up
WARM_PASSES = 1  # passes over the pool after the first, before anything is timed


def forbidden_modules(modules) -> list[str]:
    """The FORBIDDEN top-level names among the module names given."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(bench_dir: str, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    metrics: dict  # {kind: the BENCHMARK.json metrics of that kind this cell reports}

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def find_cell(name: str, bench_dir: str = BENCH_DIR) -> Cell:
    spec = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = load_json(os.path.join(bench_dir, "configs", f"{spec['config']}.json"))
    bench = load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    metrics = {
        kind: [m for m in bench[kind] if name in m.get("workloads", [name])]
        for kind in ("end_to_end", "per_layer")
    }
    return Cell(name, spec, config, metrics)


@dataclass
class Ctx:
    """What a metric reader reads."""
    setup_s: float = 0.0
    window_s: float = 0.0
    step_s: list = field(default_factory=list)  # every window step's wall time
    spans: list = field(default_factory=list)  # per traced window step: (name, t0, t1) from its start
    trace: trace.Trace | None = None  # the profiled steps
    profiled_steps: int = 0
    profiled_window_s: float = 0.0
    work: dict = field(default_factory=dict)  # {op: {"span", "ops", "bytes"}}
    peak: tuple | None = None  # (flop/s, bytes/s) of the card


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def judged(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all are within."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def short_kernel_name(name: str) -> str:
    """A device activity's name without ``void``, anonymous namespaces and
    a kernel's trailing parameter list."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    return name[:160]


def breakdown(tr: trace.Trace) -> dict:
    by_name: dict = {}
    for a in tr.activities:
        key = short_kernel_name(a.name)
        by_name[key] = by_name.get(key, 0.0) + a.dur_us / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_by_span(tr).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[f"host in {k}", v / 1e6] for k, v in gaps]}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *, device,
             t_start: float, port=None, bench_dir: str = BENCH_DIR,
             log=print) -> dict:
    """One run. ``port`` is the package under test (default: the port);
    ``log`` takes diagnostic lines (standard error in a run)."""
    if port is None:
        import pytorch3d_pointops_tpu_torch as port
    config, traffic = cell.config, cell.spec["traffic"]
    pipe = load_module(bench_dir, "pipelines", config["pipeline"])
    ref = load_module(bench_dir, "reference", config["reference"])

    dev_gen, host_gen = clouds.generators(seed, device)
    inputs = pipe.make_inputs(traffic, dev_gen, host_gen, device)
    step = pipe.Step(port, inputs, config["options"])
    m = step.entries

    # Set-up: the first pass (what the check reads), then warm-up passes.
    first = [step(j, trace.no_span) for j in range(m)]
    for j in range(m, m * (1 + WARM_PASSES)):
        step(j, trace.no_span)
    j = m * (1 + WARM_PASSES)
    _sync(device)

    ctx = Ctx(work=pipe.work_counts(inputs, config["options"]),
              peak=work.peaks(_device_kind(device)))
    if traced:
        def profiled_steps():
            nonlocal j
            from torch.profiler import record_function

            spans = trace.Spans(profiled=True)
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                with record_function(trace.PREFIX + "step"):
                    step(j, spans)
                j += 1
            ctx.profiled_window_s = time.perf_counter() - t0

        ctx.trace = trace.profiled(profiled_steps)
        ctx.profiled_steps = PROFILED_STEPS
        _sync(device)

    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way in the window
    ctx.setup_s = time.perf_counter() - t_start
    failed, attempted = 0, 0
    w0 = time.perf_counter()
    while True:
        spans = trace.Spans() if traced else None
        t0 = time.perf_counter()
        loss = step(j, spans or trace.no_span)
        t1 = time.perf_counter()
        ctx.step_s.append(t1 - t0)
        if spans is not None:
            ctx.spans.append([(n, a - t0, b - t0) for n, a, b in spans.records])
        if not (math.isfinite(loss) and loss == first[j % m]):
            failed += 1
        attempted += 1
        j += 1
        if t1 - w0 >= seconds:
            break
    ctx.window_s = t1 - w0
    gc.unfreeze()
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if torch.device(device).type == "cuda" else 0)

    t_check = time.perf_counter()
    numbers = pipe.check(step, inputs, ref, first, host_gen)
    t_check = time.perf_counter() - t_check
    checks, within = judged(numbers, config["limits"])
    correct = failed == 0 and all(math.isfinite(first[k]) for k in range(m)) and within

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for entry in cell.metrics[kind]:
        value = load_module(bench_dir, "metrics", entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": _device_kind(device), "count": cell.chips,
           "memory_peak_bytes": peak_bytes}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_us(ctx.trace) / 1e6
        dev["window_s"] = ctx.profiled_window_s
        result["breakdown"] = breakdown(ctx.trace)
        log(f"trace: {len(ctx.trace.activities)} device activities over "
            f"{ctx.profiled_steps} steps, {ctx.trace.unattributed} not attributed "
            f"to a launch; by span (ms a step): " + json.dumps(
                {s: trace.span_device_us(ctx.trace, s) / 1e3 / ctx.profiled_steps
                 for s in sorted({a.span for a in ctx.trace.activities})}))
    quarters = [ctx.step_s[k * attempted // 4:(k + 1) * attempted // 4] for k in range(4)]
    log("window quarters' median step (ms): " + " ".join(
        f"{statistics.median(q) * 1e3:.4f}" for q in quarters if q))
    median = statistics.median(ctx.step_s)
    log(f"window: {attempted} steps in {ctx.window_s:.3f} s, median step "
        f"{median * 1e3:.4f} ms, slowest {max(ctx.step_s) * 1e3:.4f} ms, "
        f"{sum(t > 1.5 * median for t in ctx.step_s)} over 1.5 x the median; "
        f"set-up {ctx.setup_s:.3f} s; "
        f"check {t_check:.3f} s; peak {peak_bytes} bytes")
    result["checks"] = checks
    return result
