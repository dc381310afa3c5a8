"""knn_fwd_roofline: the KNN forward's least time at the cell's shapes over
the device time of everything launched inside the ``port.fwd`` span of a
``knn_l2`` step (the query and candidate sorts, the sample pass, the rounds
and the repairs: whatever ``knn_points`` launches), in %, over the profiled
steps of a ``--trace 1`` run. The work is ``work.knn_forward``'s count."""

from benchmark import work


def read(ctx):
    return work.span_roofline(ctx, "knn_fwd")
