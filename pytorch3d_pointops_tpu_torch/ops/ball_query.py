"""Ball query: the first K neighbours within a radius, in PyTorch.

The port of ``pytorch3d_pointops_tpu/ops/ball_query.py``. The returned
neighbours are the **first K points in scan order** with
``dist2 < radius^2``, not the nearest K; idx is padded with -1 and dists
with 0, and rows past ``lengths1`` are all padding. The forward is
``kernels/ball_query.py`` (the Hopper kernel on CUDA tensors, its plain twin
on CPU tensors); the backward reuses the KNN backward with norm 2 on the
-1-padded idx, whose -1 entries contribute nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import tracing
from ..kernels import ball_query as _bq_kernel
from .knn import _KNN, _lengths, knn_backward
from .utils import masked_gather


class _BallQuery(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p1, p2, lengths1, lengths2, K, r2):
        N, P1, _ = p1.shape
        if N * P1 * p2.shape[1] * K == 0:
            # Every slot is padding, with no kernel launched.
            dists = p1.new_zeros((N, P1, K))
            idx = torch.full((N, P1, K), -1, dtype=torch.int64, device=p1.device)
        else:
            dists, idx = _bq_kernel.ball_query_points(p1, p2, lengths1, lengths2, K, r2)
        ctx.save_for_backward(p1, p2, lengths1, lengths2, idx)
        ctx.mark_non_differentiable(idx)
        return dists, idx

    @staticmethod
    @tracing.spanned("BallQuery.bwd")
    def backward(ctx, grad_dists, _grad_idx):
        p1, p2, lengths1, lengths2, idx = ctx.saved_tensors
        grad_p1, grad_p2 = knn_backward(
            p1, p2, lengths1, lengths2, idx, 2,
            grad_dists.to(torch.float32).contiguous(),
        )
        return grad_p1, grad_p2, None, None, None, None


@tracing.spanned("ball_query")
def ball_query(
    p1: torch.Tensor,
    p2: torch.Tensor,
    lengths1: Optional[torch.Tensor] = None,
    lengths2: Optional[torch.Tensor] = None,
    K: int = 500,
    radius: float = 0.2,
    return_nn: bool = True,
) -> _KNN:
    """First K points of ``p2`` within ``radius`` of each ``p1`` point.

    Args:
        p1: (N, P1, D) query clouds.
        p2: (N, P2, D) reference clouds, on the same device.
        lengths1 / lengths2: (N,) valid lengths (default: all P1 / P2).
        K: the most neighbours kept per query; any K >= 0 (K = 0 gives
            empty last axes).
        radius: the ball's radius; a point is inside when its squared
            distance is strictly below ``radius**2`` (formed in double and
            rounded to float32 once).
        return_nn: also gather the neighbour coordinates (zero rows at pads).

    Returns:
        ``KNN(dists, idx, knn)``: dists (N, P1, K) squared distances
        (0-padded), idx (N, P1, K) int64 (-1-padded), knn (N, P1, K, D) or
        None.
    """
    if p1.shape[0] != p2.shape[0]:
        raise ValueError("pts1 and pts2 must have the same batch dimension.")
    if p1.shape[2] != p2.shape[2]:
        raise ValueError("pts1 and pts2 must have the same point dimension.")

    p1 = p1.to(torch.float32).contiguous()
    p2 = p2.to(torch.float32).contiguous()
    N, P1, _ = p1.shape
    lengths1 = _lengths(lengths1, N, P1, p1.device)
    lengths2 = _lengths(lengths2, N, p2.shape[1], p1.device)

    dists, idx = _BallQuery.apply(
        p1, p2, lengths1, lengths2, K, _bq_kernel.squared_radius(radius)
    )
    nn = masked_gather(p2, idx) if return_nn else None
    return _KNN(dists=dists, idx=idx, knn=nn)
