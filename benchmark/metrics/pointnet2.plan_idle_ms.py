"""pointnet2.plan_idle_ms: device idle a step, in ms, in the gaps that
begin while the host is inside the model's plan: the port's
``pointnet2.plan`` span and every span opened inside it (FPS, the ball
queries, their kernel wrappers), over the profiled steps of a ``--trace 1``
run, by the benchmark's ``trace.idle_by_span`` (``port_records.py``)."""

from benchmark import port_records


def read(ctx):
    recs = port_records.mapped(ctx)
    if recs is None:
        return None
    records = [r for r, _, _ in recs]
    roots = [r for r in records if r.name == "pointnet2.plan"]
    if not roots:
        return None
    keep = port_records.with_descendants(records, roots)
    return port_records.idle_ms(ctx, [(r.name, s, e) for r, s, e in recs if r.id in keep])
