"""grid_pool_roofline: the grid pooling's least time at the cell's shapes
over the device time of the segment kernels (``csrc/segment.cu``: every
``segment_*_kernel``, found by name in any span: the pooling of the
coordinates in ``port.plan``, the features' maximum in ``port.fwd``, its
backward in ``port.bwd``), in %, over the profiled steps of a ``--trace 1``
run. The clouds' least coordinates (``scatter_reduce``), the keys' sort
(``torch.sort``), the clusters' heads and their scan (``torch.cumsum``)
are torch's and are left out of both sides. The work is the pipeline's
``grid_pool`` count, bound by bytes. None where the cell counts no such
work, the card has no peak, or no segment kernel ran."""

import re

from benchmark import work

SEGMENT = re.compile(r"\bsegment_\w+_kernel\b")


def read(ctx):
    w = ctx.work.get("grid_pool")
    if w is None or ctx.peak is None or ctx.trace is None or not ctx.profiled_steps:
        return None
    us = sum(a.dur_us for a in ctx.trace.activities if SEGMENT.search(a.name))
    if us <= 0:
        return None
    return 100.0 * work.least_s(w["ops"], w["bytes"], ctx.peak) / (us / 1e6 / ctx.profiled_steps)
