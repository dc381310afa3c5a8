"""bwd_roofline: the backward's least time at the cell's shapes over the
device time of everything launched inside the ``port.bwd`` span (the
autograd Functions' backwards and their scatters), in %, over the profiled
steps of a ``--trace 1`` run. The work is the pipeline's backward count in
``work.py`` (``knn_backward``, ``chamfer_backward``)."""

from benchmark import work


def read(ctx):
    return work.span_roofline(ctx, "bwd")
