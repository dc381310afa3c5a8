"""Chamfer distance with named per-feature cosine losses, in PyTorch.

The port of ``pytorch3d_pointops_tpu/ops/chamfer.py``: bidirectional or
``single_directional``; ``point_reduction`` in {"mean", "sum", "max", None}
(max = Hausdorff); ``batch_reduction`` in {"mean", "sum", None}; per-batch
``weights``; L1/L2 norms; named feature channels scored by ``1 - |cos|`` (or
``1 - cos`` with ``abs_cosine=False``) between each x point's feature and its
nearest y neighbour's feature. Accepts (N, P, D) tensors or ``Pointclouds``.

A bidirectional call takes both K=1 directions from one pass of
``kernels/chamfer.py`` inside a ``torch.autograd.Function`` whose backward
applies the K=1 gradient formulas and sums grad_p2 with the deterministic
segment-sum of ``kernels/scatter.py`` (``scatter_add_k1``). On CPU tensors the
same Function runs the plain twins, so the CPU path has the structure the
card runs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels import chamfer as _chamfer_kernel
from ..kernels import scatter as _scatter
from ..structures.pointclouds import Pointclouds
from .knn import _apply_pad_conventions, knn_gather, knn_points


def _validate_chamfer_reduction_inputs(batch_reduction, point_reduction):
    if batch_reduction is not None and batch_reduction not in ["mean", "sum"]:
        raise ValueError('batch_reduction must be one of ["mean", "sum"] or None')
    if point_reduction is not None and point_reduction not in ["mean", "sum", "max"]:
        raise ValueError(
            'point_reduction must be one of ["mean", "sum", "max"] or None'
        )
    if point_reduction is None and batch_reduction is not None:
        raise ValueError("Batch reduction must be None if point_reduction is None")


def _handle_pointcloud_input(points, lengths, features):
    """Normalise (Pointclouds | tensor) inputs to (padded, lengths,
    features-dict)."""
    if isinstance(points, Pointclouds):
        X = points.points_padded()
        lengths = points.num_points_per_cloud()
        features = points.features_padded()
    elif isinstance(points, torch.Tensor):
        if points.ndim != 3:
            raise ValueError("Expected points to be of shape (N, P, D)")
        X = points
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=X.device).to(torch.int64)
            if lengths.ndim != 1 or lengths.shape[0] != X.shape[0]:
                raise ValueError("Expected lengths to be of shape (N,)")
        if lengths is None:
            lengths = torch.full(
                (X.shape[0],), X.shape[1], dtype=torch.int64, device=X.device
            )
        if features is not None:
            if isinstance(features, dict):
                for name, f in features.items():
                    if f is not None and f.ndim != 3:
                        raise ValueError(f"Expected {name} to be of shape (N, P, C)")
            elif hasattr(features, "ndim") and features.ndim != 3:
                raise ValueError("Expected features to be of shape (N, P, C)")
    else:
        raise ValueError(
            "The input pointclouds should be either Pointclouds objects or "
            "tensors of shape (minibatch, num_points, 3)."
        )
    return X, lengths, features


def _cosine_similarity(a, b, eps: float = 1e-6):
    """dot / max(||a|| * ||b||, eps) over the last axis (the product of the
    norms is clamped, not each norm)."""
    dot = (a * b).sum(-1)
    na = torch.sqrt((a * a).sum(-1))
    nb = torch.sqrt((b * b).sum(-1))
    return dot / torch.clamp(na * nb, min=eps)


def _k1_backward(p1, p2, lengths1, lengths2, idx, norm, g):
    """K=1 KNN backward. The mask is on ``lengths2 > 0`` (not on
    ``k < lengths2``); grad_p2 is the deterministic segment-sum."""
    N, P1 = idx.shape
    dev = p1.device
    valid = (
        (torch.arange(P1, device=dev)[None, :] < lengths1[:, None])
        & (lengths2[:, None] > 0)
        & (idx >= 0)
    )
    p2_g = torch.gather(p2, 1, idx[..., None].expand(N, P1, p2.shape[2]))
    if norm == 1:
        sign = torch.where(p1 > p2_g, 1.0, -1.0)
        diff = g[..., None] * sign
    else:
        diff = 2.0 * g[..., None] * (p1 - p2_g)
    diff = torch.where(valid[..., None], diff, 0.0)
    grad_p2 = _scatter.scatter_add_k1(
        torch.where(valid, idx, -1), (-diff).contiguous(), p2.shape[1]
    )
    return diff, grad_p2


class _NNBidir(torch.autograd.Function):
    """Both chamfer K=1 directions from one pass, with the pad conventions
    applied per direction. Returns (d_xy, i_xy, d_yx, i_yx)."""

    @staticmethod
    def forward(ctx, x, y, x_lengths, y_lengths, norm):
        d1, i1, d2, i2 = _chamfer_kernel.chamfer_nn_bidirectional(
            x, y, x_lengths, y_lengths, norm
        )
        d1, i1 = _apply_pad_conventions(
            d1[..., None], i1[..., None], x_lengths, y_lengths, 1, x.shape[1]
        )
        d2, i2 = _apply_pad_conventions(
            d2[..., None], i2[..., None], y_lengths, x_lengths, 1, y.shape[1]
        )
        i1, i2 = i1[..., 0], i2[..., 0]
        ctx.save_for_backward(x, y, x_lengths, y_lengths, i1, i2)
        ctx.norm = norm
        ctx.mark_non_differentiable(i1, i2)
        return d1[..., 0], i1, d2[..., 0], i2

    @staticmethod
    def backward(ctx, gd1, _gi1, gd2, _gi2):
        x, y, x_lengths, y_lengths, i1, i2 = ctx.saved_tensors
        gx_a, gy_a = _k1_backward(x, y, x_lengths, y_lengths, i1, ctx.norm, gd1)
        gy_b, gx_b = _k1_backward(y, x, y_lengths, x_lengths, i2, ctx.norm, gd2)
        return gx_a + gx_b, gy_a + gy_b, None, None, None


def _nn_bidirectional(x, y, x_lengths, y_lengths, norm):
    d1, i1, d2, i2 = _NNBidir.apply(
        x.to(torch.float32).contiguous(),
        y.to(torch.float32).contiguous(),
        x_lengths.contiguous(),
        y_lengths.contiguous(),
        norm,
    )
    return (d1, i1), (d2, i2)


def _chamfer_distance_single_direction(
    x,
    y,
    x_lengths,
    y_lengths,
    x_features,
    y_features,
    weights,
    point_reduction: Union[str, None],
    norm: int,
    abs_cosine: bool,
    feature_names=None,
    nn=None,
):
    """One direction of the loss. ``nn`` optionally carries a precomputed
    (dists (N, P1), idx (N, P1)) K=1 result from the bidirectional pass."""
    if feature_names and x_features is not None and y_features is not None:
        for name in feature_names:
            if name not in x_features:
                raise ValueError(f"Feature '{name}' is missing in x_features.")
            if name not in y_features:
                raise ValueError(f"Feature '{name}' is missing in y_features.")

    return_features = (
        x_features is not None
        and y_features is not None
        and feature_names is not None
        and len(feature_names) > 0
    )

    N, P1, D = x.shape
    x_mask = torch.arange(P1, device=x.device)[None] >= x_lengths[:, None]
    if y.shape[0] != N or y.shape[2] != D:
        raise ValueError("y does not have the correct shape.")
    if weights is not None:
        if weights.shape[0] != N:
            raise ValueError("weights must be of shape (N,).")
        if bool((weights < 0).any()):
            raise ValueError("weights cannot be negative.")
        if float(weights.sum()) == 0.0:
            # Zero-sum early-out: zero losses of the shapes the normal path
            # gives, with the gradient to x kept.
            if point_reduction is None:
                z = x.sum(2) * weights[:, None] * 0.0
            else:
                z = x.sum((1, 2)) * weights * 0.0
            zf = {name: z for name in feature_names} if return_features else None
            return z, zf

    if nn is None:
        x_nn = knn_points(x, y, lengths1=x_lengths, lengths2=y_lengths, norm=norm, K=1)
        nn_dists, nn_idx = x_nn.dists[..., 0], x_nn.idx
    else:
        nn_dists, nn_idx = nn[0], nn[1][..., None]
    cham_x = torch.where(x_mask, 0.0, nn_dists)
    if weights is not None:
        cham_x = cham_x * weights[:, None]

    cham_features_x = None
    if return_features:
        cham_features_x = {}
        # One gather for all feature channels, concatenated.
        y_cat = torch.cat([y_features[name] for name in feature_names], dim=-1)
        near_cat = knn_gather(y_cat, nn_idx, y_lengths)[..., 0, :]
        off = 0
        for name in feature_names:
            x_feature = x_features[name]
            C = y_features[name].shape[-1]
            x_feature_near = near_cat[..., off : off + C]
            off += C
            cos = _cosine_similarity(x_feature, x_feature_near)
            cos = cos.abs() if abs_cosine else cos
            fd = torch.where(x_mask, 0.0, 1.0 - cos)
            if weights is not None:
                fd = fd * weights[:, None]
            cham_features_x[name] = fd

    if point_reduction == "max":
        cham_x = cham_x.max(dim=1).values
    elif point_reduction is not None:
        cham_x = cham_x.sum(dim=1)
        if return_features:
            cham_features_x = {k: v.sum(dim=1) for k, v in cham_features_x.items()}
        if point_reduction == "mean":
            x_lengths_clamped = torch.clamp(x_lengths, min=1)
            cham_x = cham_x / x_lengths_clamped
            if return_features:
                cham_features_x = {
                    k: v / x_lengths_clamped for k, v in cham_features_x.items()
                }

    return cham_x, cham_features_x


def _combine_directions(
    cham_x, cham_features_x, cham_y, cham_features_y, point_reduction
):
    """Add, take the maximum of, or pair the two directional losses,
    depending on ``point_reduction``."""
    if point_reduction == "max":
        return torch.maximum(cham_x, cham_y), None
    if point_reduction is not None:
        loss = cham_x + cham_y
        if cham_features_x is not None:
            loss_features = {
                k: cham_features_x[k] + cham_features_y[k]
                if k in cham_features_y
                else cham_features_x[k]
                for k in cham_features_x
            }
        else:
            loss_features = None
        return loss, loss_features
    loss = (cham_x, cham_y)
    if cham_features_x is not None:
        loss_features = {
            k: (cham_features_x[k], cham_features_y.get(k)) for k in cham_features_x
        }
    else:
        loss_features = None
    return loss, loss_features


def _apply_batch_reduction(cham_x, cham_features_x, weights, batch_reduction):
    if batch_reduction is None:
        return (cham_x, cham_features_x)
    N = cham_x.shape[0]
    cham_x = cham_x.sum()
    if cham_features_x is not None:
        cham_features_x = {k: v.sum() for k, v in cham_features_x.items()}
    if batch_reduction == "mean":
        if weights is None:
            div = max(N, 1)
        else:
            wsum = weights.sum()
            div = torch.where(wsum == 0.0, 1.0, wsum)
        cham_x = cham_x / div
        if cham_features_x is not None:
            cham_features_x = {k: v / div for k, v in cham_features_x.items()}
    return (cham_x, cham_features_x)


def chamfer_distance(
    x,
    y,
    x_lengths=None,
    y_lengths=None,
    x_features=None,
    y_features=None,
    weights=None,
    batch_reduction: Union[str, None] = "mean",
    point_reduction: Union[str, None] = "mean",
    norm: int = 2,
    single_directional: bool = False,
    abs_cosine: bool = True,
    feature_names: Optional[list] = None,
):
    """Chamfer distance between batches of point clouds.

    Differentiable with respect to points and features.

    Returns:
        (loss, loss_features): reduced distances and a dict of reduced
        per-feature cosine distances (or None). With ``point_reduction=None``
        the un-reduced (N, P1) / (N, P2) terms are returned as tuples.
    """
    _validate_chamfer_reduction_inputs(batch_reduction, point_reduction)
    if not (norm == 1 or norm == 2):
        raise ValueError("Support for 1 or 2 norm.")
    if point_reduction == "max" and (feature_names is not None and len(feature_names)):
        raise ValueError('Features must be None if point_reduction is "max"')

    x, x_lengths, x_features = _handle_pointcloud_input(x, x_lengths, x_features)
    y, y_lengths, y_features = _handle_pointcloud_input(y, y_lengths, y_features)
    if weights is not None:
        weights = torch.as_tensor(weights, device=x.device)

    nn_x = nn_y = None
    if not single_directional:
        nn_x, nn_y = _nn_bidirectional(x, y, x_lengths, y_lengths, norm)

    cham_x, cham_features_x = _chamfer_distance_single_direction(
        x, y, x_lengths, y_lengths, x_features, y_features,
        weights, point_reduction, norm, abs_cosine, feature_names, nn=nn_x,
    )
    if single_directional:
        loss, loss_features = cham_x, cham_features_x
    else:
        cham_y, cham_features_y = _chamfer_distance_single_direction(
            y, x, y_lengths, x_lengths, y_features, x_features,
            weights, point_reduction, norm, abs_cosine, feature_names, nn=nn_y,
        )
        loss, loss_features = _combine_directions(
            cham_x, cham_features_x, cham_y, cham_features_y, point_reduction
        )
    return _apply_batch_reduction(loss, loss_features, weights, batch_reduction)
