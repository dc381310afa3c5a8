"""device.busy_ms: the union of the device's activity intervals a step, in
ms, over the profiled steps of a ``--trace 1`` run."""

from benchmark import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.activities:
        return None
    return trace.busy_us(ctx.trace) / 1e3 / ctx.profiled_steps
