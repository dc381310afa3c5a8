"""Op-level helpers: ``masked_gather``, ``wmean``, ``get_point_covariances``,
and ``host_ints`` for the ops and models of the package.

The port of ``pytorch3d_pointops_tpu/ops/utils.py``. ``masked_gather``'s
backward is the deterministic segment-sum of ``kernels/scatter.py`` (through
``ops.knn._Gather``), so repeated backwards are bit-equal on the card, which
``torch.gather``'s own backward (float atomics) is not.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from .. import tracing
from .knn import _Gather, knn_points


def host_ints(values, device) -> torch.Tensor:
    """Host ints as an int64 tensor on ``device``. A copy to a card goes
    through pinned memory, so that it does not wait for the card's queue to
    drain as a copy from pageable memory does."""
    t = torch.as_tensor(values, dtype=torch.int64)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@tracing.spanned("masked_gather")
def masked_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``points`` at ``idx``, where ``idx == -1`` marks padding:
    padded outputs are zero rows.

    Args:
        points: (N, P, D) float tensor.
        idx: (N, K) or (N, P', K) integer tensor of indices into dim 1 of
            ``points``; -1 entries produce zero rows.

    Returns:
        (N, K, D) or (N, P', K, D) gathered values, 0.0 where idx == -1.
    """
    if idx.shape[0] != points.shape[0]:
        raise ValueError("points and idx must have the same batch dimension")
    if idx.dim() not in (2, 3):
        raise ValueError("idx format is not supported %s" % repr(tuple(idx.shape)))
    N, _, D = points.shape
    E = math.prod(idx.shape[1:])  # not -1: N may be 0
    mask = idx == -1
    # Masked slots gather row 0 and are zeroed by the where below; the
    # backward skips them (index -1) rather than adding zeros into row 0.
    idx = idx.to(torch.int64)
    safe_idx = torch.where(mask, 0, idx).reshape(N, E)
    gathered = _Gather.apply(points, safe_idx, idx.reshape(N, E))
    return torch.where(mask[..., None], 0.0, gathered.reshape(*idx.shape, D))


@tracing.spanned("wmean")
def wmean(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    axis: Union[int, Tuple[int, ...]] = -2,
    keepdims: bool = True,
    eps: float = 1e-9,
) -> torch.Tensor:
    """(Weighted) mean over ``axis`` with the last dim treated as spatial:
    ``sum(x*w) / max(sum(w), eps)``."""
    if weight is None:
        return x.mean(dim=axis, keepdim=keepdims)
    if any(
        xd != wd and xd != 1 and wd != 1
        for xd, wd in zip(x.shape[-2::-1], weight.shape[::-1])
    ):
        raise ValueError("wmean: weights are not compatible with the tensor")
    num = (x * weight[..., None]).sum(dim=axis, keepdim=keepdims)
    den = weight[..., None].sum(dim=axis, keepdim=keepdims)
    return num / den.clamp(min=eps)


@tracing.spanned("get_point_covariances")
def get_point_covariances(
    points_padded: torch.Tensor,
    num_points_per_cloud: torch.Tensor,
    neighborhood_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point covariance of the K-neighbourhood of each point.

    Returns ``(covariances (N, P, D, D), k_nearest_neighbors (N, P, K, D))``.
    """
    knn = knn_points(
        points_padded,
        points_padded,
        lengths1=num_points_per_cloud,
        lengths2=num_points_per_cloud,
        K=neighborhood_size,
        return_nn=True,
    ).knn
    pt_mean = knn.mean(dim=2, keepdim=True)
    central_diff = knn - pt_mean
    per_pt_cov = central_diff[..., None] * central_diff[..., None, :]
    covariances = per_pt_cov.mean(dim=2)
    return covariances, knn
