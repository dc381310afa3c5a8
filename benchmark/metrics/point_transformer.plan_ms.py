"""point_transformer.plan_ms: device time a step, in ms, of everything
launched inside the ``port.plan`` span (the model's FPS and KNN of every
level and the small ops around them), over the profiled steps of a
``--trace 1`` run. None where no device time was launched there."""

from benchmark import trace


def read(ctx):
    if ctx.trace is None or not ctx.profiled_steps:
        return None
    us = trace.span_device_us(ctx.trace, "port.plan")
    return us / 1e3 / ctx.profiled_steps if us > 0 else None
