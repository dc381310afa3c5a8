"""step_p95_ms: the 95th percentile of every window step's wall time, from
the step's start to its loss on the host, in ms (host clock)."""

import statistics


def read(ctx):
    if len(ctx.step_s) < 2:
        return None
    return 1e3 * statistics.quantiles(ctx.step_s, n=20, method="inclusive")[18]
