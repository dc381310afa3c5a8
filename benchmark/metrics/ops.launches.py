"""ops.launches: device activities (kernels, memsets, copies) a step, over
the profiled steps of a ``--trace 1`` run (``torch.profiler``)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.activities:
        return None
    return len(ctx.trace.activities) / ctx.profiled_steps
