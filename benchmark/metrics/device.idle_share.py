"""device.idle_share: 100 x (1 - device.busy_ms / the mean wall time of the
same run's unprofiled window steps), in %. The wall time is taken with the
profiler off, so its host overhead does not count as idleness."""

from benchmark import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.activities or not ctx.step_s:
        return None
    busy_ms = trace.busy_us(ctx.trace) / 1e3 / ctx.profiled_steps
    wall_ms = 1e3 * sum(ctx.step_s) / len(ctx.step_s)
    return 100.0 * (1.0 - busy_ms / wall_ms)
