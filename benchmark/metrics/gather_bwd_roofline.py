"""gather_bwd_roofline: the gather backward's least time at the cell's
shapes over the device time of the scatter's own kernels
(``csrc/scatter.cu``: ``radix_histogram``, ``radix_onesweep``,
``bucket_sum_kernel``) launched inside the ``port.bwd`` span, in %, over
the profiled steps of a ``--trace 1`` run. The rest of that span (the
model's whole backward) is left out; so is the scatter's one memset, which
the trace does not tell from the backward's others. The work is the
pipeline's ``gather_bwd`` count. None where the cell counts no such work,
the card has no peak, or no scatter kernel ran there."""

import re

from benchmark import work

SCATTER = re.compile(r"\b(radix_histogram|radix_onesweep|bucket_sum_kernel)\b")


def read(ctx):
    w = ctx.work.get("gather_bwd")
    if w is None or ctx.peak is None or ctx.trace is None or not ctx.profiled_steps:
        return None
    us = sum(a.dur_us for a in ctx.trace.activities
             if a.span == w["span"] and SCATTER.search(a.name))
    if us <= 0:
        return None
    return 100.0 * work.least_s(w["ops"], w["bytes"], ctx.peak) / (us / 1e6 / ctx.profiled_steps)
