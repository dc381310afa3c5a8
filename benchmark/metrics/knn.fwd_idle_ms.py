"""knn.fwd_idle_ms: device idle a step, in ms, in the gaps that begin while
the host is inside ``knn_points``'s forward: the port's ``knn_points`` span
and every span opened inside it (the sorts, the sample pass, the rounds,
the repair, the kernel wrapper), over the profiled steps of a ``--trace 1``
run, by the benchmark's ``trace.idle_by_span`` (``port_records.py``)."""

from benchmark import port_records


def read(ctx):
    recs = port_records.mapped(ctx)
    if recs is None:
        return None
    records = [r for r, _, _ in recs]
    roots = [r for r in records if r.name == "knn_points"]
    if not roots:
        return None
    keep = port_records.with_descendants(records, roots)
    return port_records.idle_ms(ctx, [(r.name, s, e) for r, s, e in recs if r.id in keep])
