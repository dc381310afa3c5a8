"""K-nearest neighbours on padded point-cloud batches, in PyTorch.

The port of ``pytorch3d_pointops_tpu/ops/knn.py``. The forward is the
brute-force top-K of ``kernels/knn.py`` (the Hopper kernel on CUDA tensors,
its plain twin on CPU tensors); the backward is a ``torch.autograd.Function``
with the exact gradient formulas of the reference CUDA backward: for L2,
``2*g*(p1-p2)`` into grad_p1 and its negative scattered into grad_p2; for L1,
``g*sign(p1-p2)`` with ``sign(0) = -1``. The scatter is the deterministic
segment-sum of ``kernels/scatter.py``.

Pad conventions: ``dists`` are squared L2 distances (or L1 sums), ascending;
entries where ``k >= lengths2[n]`` or ``i >= lengths1[n]`` are 0 with idx 0.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional

import torch

from .. import tracing
from ..kernels import knn as _knn_kernel
from ..kernels import scatter as _scatter

_KNN = namedtuple("KNN", "dists idx knn")


def _apply_pad_conventions(vals, idx, lengths1, lengths2, K, P1):
    """Zero rows past lengths1 and columns past lengths2."""
    dev = vals.device
    k_valid = torch.arange(K, device=dev)[None, None, :] < lengths2[:, None, None]
    i_valid = torch.arange(P1, device=dev)[None, :, None] < lengths1[:, None, None]
    valid = k_valid & i_valid
    return torch.where(valid, vals, 0.0), torch.where(valid, idx, 0)


def _scatter_rows(idx, contrib, P2: int):
    """``kernels.scatter.scatter_add_rows``, or zeros of its output shape
    where there is nothing to add: no entry, no target row or no channel.
    A shape test on the host: no kernel meets a zero-size grid."""
    N, E, C = contrib.shape
    if N * E * P2 * C == 0:
        return contrib.new_zeros((N, P2, C), dtype=torch.float32)
    return _scatter.scatter_add_rows(idx, contrib, P2)


def knn_backward(p1, p2, lengths1, lengths2, idx, norm, grad_dists):
    """Gradient of the (squared) KNN distances with respect to p1 and p2.

    Entries with ``idx < 0``, ``i >= lengths1`` or ``k >= lengths2``
    contribute 0. grad_p2 is a deterministic segment-sum. Where p2 has no
    point or idx no entry, both gradients are zeros and nothing is
    gathered."""
    N, P1, K = idx.shape
    D = p1.shape[2]
    dev = p1.device
    if p2.shape[1] == 0 or idx.numel() == 0:
        return torch.zeros_like(p1), torch.zeros_like(p2)
    valid = (
        (torch.arange(P1, device=dev)[None, :, None] < lengths1[:, None, None])
        & (torch.arange(K, device=dev)[None, None, :] < lengths2[:, None, None])
        & (idx >= 0)
    )
    safe_idx = torch.where(idx >= 0, idx, 0)
    p2_g = torch.gather(
        p2, 1, safe_idx.reshape(N, P1 * K, 1).expand(N, P1 * K, D)
    ).reshape(N, P1, K, D)
    if norm == 1:
        sign = torch.where(p1[:, :, None, :] > p2_g, 1.0, -1.0)
        diff = grad_dists[..., None] * sign
    else:
        diff = 2.0 * grad_dists[..., None] * (p1[:, :, None, :] - p2_g)
    diff = torch.where(valid[..., None], diff, 0.0)
    grad_p1 = diff.sum(dim=2)
    grad_p2 = _scatter_rows(
        torch.where(valid, idx, -1).reshape(N, P1 * K),
        (-diff).reshape(N, P1 * K, D),
        p2.shape[1],
    )
    return grad_p1, grad_p2


def _all_pads(p1, p2, K):
    """(dists, idx) of (N, P1, K) zeros where p1 and p2 have no pair of
    points or K is 0 (every entry is a pad), else None: a shape test on the
    host, so that no kernel, gather or hop meets an empty axis."""
    N, P1, _ = p1.shape
    if N * P1 * p2.shape[1] * K:
        return None
    return (p1.new_zeros((N, P1, K)),
            torch.zeros((N, P1, K), dtype=torch.int64, device=p1.device))


def _knn_forward(p1, p2, lengths1, lengths2, K, norm):
    pads = _all_pads(p1, p2, K)
    if pads is not None:
        return pads
    vals, idx = _knn_kernel.knn_topk(p1, p2, lengths2, K, norm)
    return _apply_pad_conventions(vals, idx, lengths1, lengths2, K, p1.shape[1])


class _KnnPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p1, p2, lengths1, lengths2, K, norm):
        dists, idx = _knn_forward(p1, p2, lengths1, lengths2, K, norm)
        ctx.save_for_backward(p1, p2, lengths1, lengths2, idx)
        ctx.norm = norm
        ctx.mark_non_differentiable(idx)
        return dists, idx

    @staticmethod
    @tracing.spanned("KnnPoints.bwd")
    def backward(ctx, grad_dists, _grad_idx):
        p1, p2, lengths1, lengths2, idx = ctx.saved_tensors
        grad_p1, grad_p2 = knn_backward(
            p1, p2, lengths1, lengths2, idx, ctx.norm, grad_dists.contiguous()
        )
        return grad_p1, grad_p2, None, None, None, None


def _lengths(lengths, N, P, device):
    if lengths is None:
        return torch.full((N,), P, dtype=torch.int64, device=device)
    return torch.as_tensor(lengths, device=device).to(torch.int64).contiguous()


@tracing.spanned("knn_points")
def knn_points(
    p1: torch.Tensor,
    p2: torch.Tensor,
    lengths1: Optional[torch.Tensor] = None,
    lengths2: Optional[torch.Tensor] = None,
    norm: int = 2,
    K: int = 1,
    version: int = -1,
    return_nn: bool = False,
    return_sorted: bool = True,
) -> _KNN:
    """K nearest neighbours from each point of ``p1`` to the points of ``p2``.

    Args:
        p1: (N, P1, D) query clouds.
        p2: (N, P2, D) reference clouds, on the same device.
        lengths1 / lengths2: (N,) valid lengths (default: all P1 / P2).
        norm: 1 (L1) or 2 (squared L2).
        K: number of neighbours; any K >= 0 (K = 0 gives empty last
            axes).
        version: accepted for API compatibility with the reference's CUDA
            kernel-version knob; ignored.
        return_nn: also gather the neighbour coordinates via ``knn_gather``.
        return_sorted: if False (and K > 1), each row is reordered by
            neighbour index (the streaming kernel's scan order), pad entries
            kept at the tail.

    Returns:
        ``KNN(dists, idx, knn)``: dists (N, P1, K) float32, idx (N, P1, K)
        int64, knn (N, P1, K, D) or None.
    """
    if p1.shape[0] != p2.shape[0]:
        raise ValueError("pts1 and pts2 must have the same batch dimension.")
    if p1.shape[2] != p2.shape[2]:
        raise ValueError("pts1 and pts2 must have the same point dimension.")
    if not (norm == 1 or norm == 2):
        raise ValueError("Support for 1 or 2 norm.")
    del version

    p1 = p1.to(torch.float32).contiguous()
    p2 = p2.to(torch.float32).contiguous()
    N, P1, _ = p1.shape
    P2 = p2.shape[1]
    lengths1 = _lengths(lengths1, N, P1, p1.device)
    lengths2 = _lengths(lengths2, N, P2, p1.device)

    dists, idx = _KnnPoints.apply(p1, p2, lengths1, lengths2, K, norm)

    if not return_sorted and K > 1:
        key = torch.where(
            torch.arange(K, device=p1.device)[None, None, :]
            < lengths2[:, None, None],
            idx,
            2**62,
        )
        order = torch.argsort(key, dim=2, stable=True)
        dists = torch.gather(dists, 2, order)
        idx = torch.gather(idx, 2, order)

    nn = knn_gather(p2, idx, lengths2) if return_nn else None
    return _KNN(dists=dists, idx=idx, knn=nn)


def knn_check_version(version: int, D: int, K: int) -> bool:
    """API-parity shim for the reference's ``knn_check_version``: whether
    the given reference CUDA kernel variant would be valid for (D, K)."""
    if version == 0:
        return True
    if version == 1:
        return 1 <= D <= 32
    if version == 2:
        return 1 <= D <= 8 and 1 <= K <= 32
    if version == 3:
        return 1 <= D <= 8 and 1 <= K <= 4
    return False


class _Gather(torch.autograd.Function):
    """Row gather whose backward is the deterministic segment-sum.

    The forward gathers at ``idx_flat`` (every entry a valid row); the
    backward scatters at ``scatter_idx``, which is -1 where the caller masks
    the gathered value out. Those entries would only add exact zeros, and
    sending them to a real row (row 0, say) makes one long segment there."""

    @staticmethod
    def forward(ctx, x, idx_flat, scatter_idx):
        ctx.save_for_backward(scatter_idx)
        ctx.rows = x.shape[1]
        U = x.shape[2]
        if ctx.rows == 0:  # no row to gather: every entry is masked out
            return x.new_zeros((*idx_flat.shape, U))
        return torch.gather(
            x, 1, idx_flat[..., None].expand(*idx_flat.shape, U)
        )

    @staticmethod
    @tracing.spanned("Gather.bwd")
    def backward(ctx, grad_out):
        (scatter_idx,) = ctx.saved_tensors
        grad_x = _scatter_rows(
            scatter_idx, grad_out.to(torch.float32).contiguous(), ctx.rows
        )
        return grad_x, None, None


@tracing.spanned("knn_gather")
def knn_gather(
    x: torch.Tensor, idx: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Gather (N, M, U) values by KNN indices (N, L, K) -> (N, L, K, U),
    zero-filling entries where ``k >= lengths[n]``."""
    N, M, U = x.shape
    _N, L, K = idx.shape
    if N != _N:
        raise ValueError("x and idx must have same batch dimension.")
    lengths = _lengths(lengths, N, M, x.device)
    mask = torch.arange(K, device=x.device)[None, None, :] < lengths[:, None, None]
    idx = idx.to(torch.int64)
    x_out = _Gather.apply(
        x, idx.reshape(N, L * K), torch.where(mask, idx, -1).reshape(N, L * K)
    )
    x_out = x_out.reshape(N, L, K, U)
    return torch.where(mask[..., None], x_out, 0.0)
