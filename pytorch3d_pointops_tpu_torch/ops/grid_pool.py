"""Grid pooling of packed point clouds (Point Transformer V2's ``GridPool``,
Wu et al. 2022, arXiv:2210.05666; Pointcept's ``point_transformer_v2m2_base.py``).

``grid_pool(pos, lengths, grid_size)`` clusters the rows of each cloud by
the voxel of a grid of cell ``grid_size`` that holds them, counted from
the cloud's least coordinate on each axis. Clusters are numbered by cloud,
then by the voxel's z, y and x (torch_cluster's ``grid_cluster`` after
``torch.unique(sorted=True)``), and each cluster's position is the mean of
its rows' coordinates: their float32 sum in sorted order, divided by its
count. ``grid_pool_max(x, pool)`` gives each cluster the channel-wise
maximum of its rows' features, the first of equal maxima in sorted order;
its backward sends each output gradient to the row that held the maximum,
a plain indexed write (each row lies in one cluster), so it is
deterministic. The kernels are ``csrc/segment.cu`` (``kernels/segment.py``);
the clouds' least coordinates (``scatter_reduce``), the keys' stable sort
(``torch.sort``) and the clusters' heads and their scan are torch's.

The number of clusters depends on the data. ``grid_pool`` reads it to the
host once, the clusters of every cloud in one copy (``sync.grid_pool.counts``),
and nothing else; neither ``torch.unique`` nor a mask's size, which sync
without being counted, is used.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from .. import tracing
from ..kernels import segment as _segment
from .utils import host_ints

CLUSTERS = "grid_pool.clusters"


class GridPool(NamedTuple):
    """The pooling of T packed rows into M clusters."""

    pos: torch.Tensor  # (M, 3) each cluster's mean coordinates, cloud after cloud
    lengths: List[int]  # each cloud's clusters, host ints
    cluster: torch.Tensor  # (T,) int64: each row's cluster
    order: torch.Tensor  # (T,) int64: the rows, stably sorted by cluster
    offsets: torch.Tensor  # (M + 1,) int64: cluster m is order[offsets[m]:offsets[m + 1]]


@tracing.spanned("grid_pool")
def grid_pool(pos: torch.Tensor, lengths: Sequence[int], grid_size: float) -> GridPool:
    """Pool packed points ``pos`` (T, 3) float32, the rows of each cloud
    consecutive (``lengths``, host ints summing to T), on a grid of cell
    ``grid_size`` (rounded to float32). A row's voxel on each axis is
    ``(int64)((p - start) / grid_size)`` in float32, ``start`` its cloud's
    least coordinate. Raises ``ValueError`` where a cloud spans 2^17 cells
    or more on an axis, or a coordinate is NaN, and past 4,096 clouds."""
    lengths = [int(n) for n in lengths]
    T, N, dev = pos.shape[0], len(lengths), pos.device
    if pos.dim() != 2 or pos.shape[1] != 3 or sum(lengths) != T or min(lengths, default=0) < 0:
        raise ValueError(f"grid_pool takes (T, 3) points and cloud lengths summing to T "
                         f"(got {tuple(pos.shape)} and {lengths})")
    if pos.dtype != torch.float32:
        raise ValueError(f"grid_pool takes float32 points (got {pos.dtype})")
    if N > _segment.MAX_CLOUDS:
        raise ValueError(f"grid_pool takes at most {_segment.MAX_CLOUDS} clouds (got {N})")
    pos = pos.contiguous()
    if T == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return GridPool(pos, [0] * N, empty, empty, torch.zeros(1, dtype=torch.int64, device=dev))
    firsts = [sum(lengths[:n]) for n in range(N + 1)]
    bounds = host_ints(firsts, dev)
    # Each cloud's least coordinate: exact in any order of the rows.
    cloud = torch.repeat_interleave(torch.arange(N, device=dev), bounds.diff(), output_size=T)
    start = torch.full((N, 3), torch.inf, device=dev).scatter_reduce(
        0, cloud[:, None].expand(T, 3), pos, "amin")
    info = torch.zeros(N + 1, dtype=torch.int64, device=dev)  # clusters by cloud, flag
    keys = _segment.segment_keys(pos, bounds[:-1], start, grid_size, info[N:])
    keys, order = torch.sort(keys, stable=True)
    heads = torch.ones_like(keys)  # 1 where a sorted key differs from the one before
    heads[1:] = keys[1:] != keys[:-1]
    ids = torch.cumsum(heads, 0)
    offsets, cluster = _segment.segment_bounds(ids, order, bounds[1:], T + 1, info[:N])
    tracing.sync("grid_pool.counts")
    *running, flag = info.tolist()
    if flag:
        raise ValueError(f"grid_pool: a cloud spans 2^{_segment.AXIS_BITS} cells of "
                         f"{grid_size} or more on an axis, or a coordinate is NaN")
    counts = [b - a for a, b in zip([0] + running, running)]
    M = running[-1] if N else 0
    tracing.count(CLUSTERS, M)
    offsets = offsets[:M + 1]
    return GridPool(_segment.segment_sum(pos, order, offsets, mean=True), counts, cluster, order,
                    offsets)


class _GridPoolMax(torch.autograd.Function):
    """Each cluster's channel-wise maximum; the backward writes each output
    gradient into the row that held the maximum."""

    @staticmethod
    def forward(ctx, x, order, offsets, cluster):
        out, arg = _segment.segment_max(x, order, offsets)
        ctx.save_for_backward(arg, cluster)
        ctx.dtype = x.dtype
        return out

    @staticmethod
    @tracing.spanned("GridPool.bwd")
    def backward(ctx, grad_out):
        arg, cluster = ctx.saved_tensors
        return (_segment.segment_max_backward(grad_out.to(ctx.dtype), arg, cluster),
                None, None, None)


@tracing.spanned("grid_pool_max")
def grid_pool_max(x: torch.Tensor, pool: GridPool) -> torch.Tensor:
    """(M, C): each cluster of ``pool`` the channel-wise maximum of its rows
    of ``x`` (T, C), the first of equal maxima in sorted order.
    Differentiable in ``x``. Float32 on the card; the CPU also takes
    float64."""
    if x.dim() != 2 or x.shape[0] != pool.cluster.shape[0]:
        raise ValueError(f"grid_pool_max takes (T, C) features of the pooled rows "
                         f"(got {tuple(x.shape)} for {pool.cluster.shape[0]} rows)")
    if pool.offsets.shape[0] == 1 or x.shape[1] == 0:  # no cluster or no channel
        return x.new_zeros((pool.offsets.shape[0] - 1, x.shape[1]))
    return _GridPoolMax.apply(x, pool.order, pool.offsets, pool.cluster)
