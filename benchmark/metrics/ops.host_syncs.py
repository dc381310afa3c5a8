"""ops.host_syncs: the port's reads of tensor values to the host (its
``sync.*`` counters) a step, over the profiled steps of a ``--trace 1`` run,
from the port's own span records (``port_records.py``). A read the step
makes itself, such as its loss, is not the port's and is not counted."""

from benchmark import port_records


def read(ctx):
    recs = port_records.mapped(ctx)
    if recs is None:
        return None
    syncs = sum(n for r, _, _ in recs for k, n in r.counts.items() if k.startswith("sync."))
    return syncs / ctx.profiled_steps
