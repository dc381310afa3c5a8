"""The port's own spans (``pytorch3d_pointops_tpu_torch.tracing``) of a
``--trace 1`` run, on the profiled trace's clock, for the metrics that read
them.

The port records its spans while ``torch.profiler`` records, so in a run of
the benchmark its records are those of the profiled steps. They are kept in
the port's memory: the trace's reduction keeps only ``bench.*`` ranges.
A record is stamped with ``time.time_ns()``; the profiler's Chrome export
puts host times in microseconds from a base that it floors to
``tracing.TRACE_BASE_SECONDS``. The mapping is held to a check: every span
the main thread opened outside any other (an entry point, called by the
step) must lie inside one of the step's ``bench`` ``port.*`` spans. Where
the port has no ``tracing`` module (a checkout from before it), no record,
or a mapping that fails the check, there is nothing to read (None).
"""

from __future__ import annotations

import importlib
import threading

from benchmark import trace

# How far an entry span may pass its bench span (us): room for the
# profiler's conversion of its host clock, where a wrong base is off by a
# second or more.
SLACK_US = 20.0


def _tracing():
    try:
        return importlib.import_module("pytorch3d_pointops_tpu_torch.tracing")
    except ImportError:
        return None


def _inside_port_spans(entries, port_spans) -> bool:
    return all(any(ps - SLACK_US <= s and e <= pe + SLACK_US for ps, pe in port_spans)
               for s, e in entries)


def mapped(ctx):
    """The port's records as [(record, start_us, end_us)] on the trace's
    clock, or None (see the module's docstring)."""
    tracing = _tracing()
    if tracing is None or ctx.trace is None or not ctx.profiled_steps:
        return None
    records = tracing.records()
    main = threading.main_thread().ident
    entries = [r for r in records if r.parent is None and r.thread == main]
    port_spans = [(s, e) for name, s, e in ctx.trace.host_spans if name.startswith("port.")]
    if not entries or not port_spans:
        return None
    now_s = max(r.end_ns for r in records) / 1e9
    # The export came after the last record, within one base interval.
    for at in (now_s, now_s + tracing.TRACE_BASE_SECONDS):
        base = tracing.trace_base_ns(at)
        if _inside_port_spans([(tracing.trace_us(r.start_ns, base),
                                tracing.trace_us(r.end_ns, base)) for r in entries],
                              port_spans):
            return [(r, tracing.trace_us(r.start_ns, base), tracing.trace_us(r.end_ns, base))
                    for r in records]
    return None


def with_descendants(records, roots) -> set:
    """The ids of ``roots`` and of every record opened inside one of them."""
    parent = {r.id: r.parent for r in records}
    keep = {r.id for r in roots}
    for r in records:
        chain, p = [], r.id
        while p is not None and p not in keep:
            chain.append(p)
            p = parent.get(p)
        if p is not None:
            keep.update(chain)
    return keep


def idle_ms(ctx, spans) -> float:
    """Device idle a profiled step, in ms, in the gaps that begin while the
    host is inside one of ``spans`` ([(name, start_us, end_us)]): the
    benchmark's own ``trace.idle_by_span`` over those spans."""
    tr = trace.Trace(activities=ctx.trace.activities, steps=ctx.trace.steps,
                     host_spans=list(spans))
    idle = trace.idle_by_span(tr)
    return sum(v for k, v in idle.items() if k != trace.OUTSIDE) / 1e3 / ctx.profiled_steps
