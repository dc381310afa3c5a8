"""Spans around the calls into the port, and the reduction of a
``torch.profiler`` trace to device activities attributed to those spans.

A pipeline's step wraps each call into the port, and each stretch of its
own code, in ``span(name)``. Untraced runs pass ``no_span``, which does
nothing. The traced run passes a ``Spans`` recorder: it keeps each span's
host start and end (``time.perf_counter``) and, while the profiler runs,
opens a ``record_function`` range named ``bench.<name>``; the harness wraps
every profiled step in ``bench.step``.

The reduction reads the profiler's Chrome trace. A device activity
(kernel, memset, copy) carries the correlation id of the host call that
launched it; the host call lies inside the innermost ``bench.*`` range
open at that moment, and that range's name is the activity's span.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside_spans"

_NULL = contextlib.nullcontext()


def no_span(_name: str):
    return _NULL


class Spans:
    """Host spans of one step: ``records`` holds (name, start s, end s)."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiled:
            from torch.profiler import record_function

            with record_function(PREFIX + name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))


@dataclass
class Activity:
    name: str
    start_us: float
    dur_us: float
    span: str  # the innermost bench span its launch lay in, or OUTSIDE


@dataclass
class Trace:
    activities: list = field(default_factory=list)
    host_spans: list = field(default_factory=list)  # (name, start_us, end_us)
    steps: list = field(default_factory=list)  # (start_us, end_us) of bench.step
    unattributed: int = 0  # activities whose launch was not found


def _innermost(spans, t):
    """Name of the innermost span (shortest) containing host time t."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else OUTSIDE


def reduce_events(events: list) -> Trace:
    """Device activities of a Chrome trace's events, each attributed to a
    span; the bench spans and the profiled steps."""
    launches, spans, steps, device = {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            name = e["name"][len(PREFIX):]
            iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            (steps.append(iv) if name == "step" else spans.append((name, *iv)))
        elif cat in DEVICE_CATS:
            device.append(e)
        elif "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
    trace = Trace(host_spans=spans, steps=sorted(steps))
    for e in sorted(device, key=lambda e: float(e["ts"])):
        launched = launches.get((e.get("args") or {}).get("correlation"))
        if launched is None:
            trace.unattributed += 1
        span = OUTSIDE if launched is None else _innermost(spans, launched)
        trace.activities.append(Activity(e["name"], float(e["ts"]),
                                         float(e.get("dur", 0)), span))
    return trace


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and CUDA activities) and
    return its Chrome trace reduced. The trace goes through a temporary
    file under ``$TMPDIR``, deleted at once."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def busy_us(trace: Trace) -> float:
    """Device-busy time: the union of every activity's interval."""
    return union_us((a.start_us, a.start_us + a.dur_us) for a in trace.activities)


def span_device_us(trace: Trace, span: str) -> float:
    """Device time of the activities launched inside ``span``."""
    return sum(a.dur_us for a in trace.activities if a.span == span)


def idle_by_span(trace: Trace) -> dict:
    """Device idle time inside the profiled steps, by the host span open
    when each idle stretch began."""
    if not trace.steps:
        return {}
    lo, hi = trace.steps[0][0], trace.steps[-1][1]
    merged = []
    for a in sorted(trace.activities, key=lambda a: a.start_us):
        s, e = a.start_us, a.start_us + a.dur_us
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, cursor = [], lo
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if cursor < hi:
        gaps.append((cursor, hi))
    out = {}
    for s, e in gaps:
        if e > s:
            label = _innermost(trace.host_spans, s)
            out[label] = out.get(label, 0.0) + (e - s)
    return out
