"""ops.bwd_idle_ms: device idle a step, in ms, in the gaps that begin while
any thread is inside one of the port's autograd backwards (its ``*.bwd``
spans: the Functions' backwards and the scatters inside them), over the
profiled steps of a ``--trace 1`` run, by the benchmark's
``trace.idle_by_span`` (``port_records.py``). Time in torch's own backward
nodes outside those spans is not counted."""

from benchmark import port_records


def read(ctx):
    recs = port_records.mapped(ctx)
    if recs is None:
        return None
    spans = [(r.name, s, e) for r, s, e in recs if r.name.endswith(".bwd")]
    if not spans:
        return None
    return port_records.idle_ms(ctx, spans)
