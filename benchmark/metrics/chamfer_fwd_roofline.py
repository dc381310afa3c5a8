"""chamfer_fwd_roofline: the chamfer forward's least time at the cell's
shapes over the device time of everything launched inside the ``port.fwd``
span of a ``chamfer_nc`` step (``update_padded`` and ``chamfer_distance``),
in %, over the profiled steps of a ``--trace 1`` run. The work is
``work.chamfer_forward``'s count."""

from benchmark import work


def read(ctx):
    return work.span_roofline(ctx, "chamfer_fwd")
