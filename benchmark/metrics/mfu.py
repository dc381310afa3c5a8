"""mfu: the dense layers' float32 operations a step (``work_counts``'s
``dense``: every shared MLP and FC layer's forward, weight and input
gradients, 2 a multiply-add, from the widths and shapes alone) over the
card's float32 peak (``work.PEAKS``) times the median window step, in %.
None where the cell counts no dense work or the card has no peak."""

import statistics


def read(ctx):
    w = ctx.work.get("dense")
    if w is None or ctx.peak is None or not ctx.step_s:
        return None
    return 100.0 * w["ops"] / (ctx.peak[0] * statistics.median(ctx.step_s))
