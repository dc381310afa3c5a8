"""Iterative farthest point sampling (FPS), in PyTorch.

The port of ``pytorch3d_pointops_tpu/ops/fps.py``. The selection is
sequential over the K rounds and data-parallel over the points of a round;
on ties the argmax keeps the first maximal index. idx is padded with -1 past
``min(K[n], lengths[n])``, the gathered points with zero rows; the start
index is 0 unless ``random_start_point``. The selection carries no
gradient: the sampled points are differentiable through ``masked_gather``.

On CUDA tensors ``route`` sends each batch to one of the four FPS
entry points of ``kernels/fps.py`` by cloud size; on CPU tensors
every route runs the plain twin.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import tracing
from ..kernels import fps as _fps
from .knn import _lengths
from .utils import host_ints, masked_gather


def _normalize_K(K, N: int, device) -> Tuple[torch.Tensor, int]:
    """K as an int, a list or tuple, or an (N,) array or tensor, to an (N,)
    int64 tensor on ``device`` and its maximum as a host int. The maximum of
    a K given on the host is taken there, so only a K given as a tensor is
    read back (``sync.fps.max_k``)."""
    if isinstance(K, (int, np.integer)):
        K_t = torch.full((N,), int(K), dtype=torch.int64, device=device)
        return K_t, max(int(K), 0) if N else 0
    if isinstance(K, torch.Tensor):
        K_t = K.to(torch.int64).reshape(-1)
        if K_t.shape[0] != N:
            raise ValueError("K and points must have the same batch dimension")
        K_t = K_t.to(device)
        if not K_t.numel():
            return K_t, 0
        tracing.sync("fps.max_k")
        return K_t, max(int(K_t.max()), 0)
    K_np = np.asarray(K).astype(np.int64).reshape(-1)
    if K_np.shape[0] != N:
        raise ValueError("K and points must have the same batch dimension")
    max_K = max(int(K_np.max()), 0) if K_np.size else 0
    return host_ints(K_np, device), max_K


# The largest single cloud ``route`` sends to the cluster path: past it one
# cluster of 16 SMs takes longer a round than the grid kernel on every SM
# (``tune_fps.py --cluster``, PERF.md). Two clouds or more take the cluster
# path up to ``cluster_limit``: the grid kernel runs them in turn.
ONE_CLOUD_CLUSTER_MAX = 180_000


def route(points: torch.Tensor):
    """The FPS entry point for this batch: one block per cloud up to the
    block cap of ``fps_limits`` ((D + 1) * 4 bytes a point of one block's
    shared memory); else, at D=3 up to ``cluster_limit`` (one cloud: up to
    ``ONE_CLOUD_CLUSTER_MAX``), one thread-block cluster per cloud with
    every cloud at once; else the whole card with the cloud on chip while
    it fits there, else the whole card streaming part of it from device
    memory (the last two run the same grid kernel plan up to the resident
    cap, cloud after cloud). On an H100 the block kernel is the faster at
    every batch shape it takes, one cloud at its limit included (1 x 14,000
    points: 0.96-0.99 ms against 1.07-1.16 over two runs; ``tune_fps.py``,
    PERF.md), and the cluster path past it wherever it runs
    (``tune_fps.py --cluster``, PERF.md)."""
    N, P, D = points.shape
    if not points.is_cuda:
        return _fps.fps_batched  # every entry point runs the plain twin here
    block_max, resident_max = _fps.fps_limits(D, points.device)
    if P <= block_max:
        return _fps.fps_batched
    if P <= _fps.cluster_limit(D, points.device) and (N > 1 or P <= ONE_CLOUD_CLUSTER_MAX):
        return _fps.fps_clustered
    if P <= resident_max:
        return _fps.fps_resident
    return _fps.fps_streaming


def _random_starts(lengths, generator):
    """floor(u * max(length, 1)), clipped to length - 1, with u uniform in
    [0, 1) drawn from ``generator``."""
    u = torch.rand((lengths.shape[0],), generator=generator,
                   device=generator.device).to(lengths.device)
    starts = torch.floor(u * lengths.clamp(min=1)).to(torch.int64)
    return torch.minimum(starts, (lengths - 1).clamp(min=0))


def _prepare(points, lengths, K, random_start_point, generator):
    N, P, _ = points.shape
    lengths = _lengths(lengths, N, P, points.device)
    if lengths.shape != (N,):
        raise ValueError("points and lengths must have same batch dimension.")
    K_t, max_K = _normalize_K(K, N, points.device)
    if random_start_point:
        if generator is None:
            raise ValueError(
                "random_start_point=True requires a torch.Generator `generator`."
            )
        starts = _random_starts(lengths, generator)
    else:
        starts = torch.zeros((N,), dtype=torch.int64, device=points.device)
    return lengths, K_t, max_K, starts


@tracing.spanned("sample_farthest_points")
def sample_farthest_points(
    points: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    K: Union[int, List, torch.Tensor] = 50,
    random_start_point: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subsample ``K`` maximally spread points per cloud.

    Args:
        points: (N, P, D) clouds.
        lengths: (N,) valid lengths (default all P).
        K: int, list, or (N,) array or tensor of per-cloud sample counts.
        random_start_point: start from a random valid index per cloud.
        generator: the ``torch.Generator`` for random starts; required iff
            ``random_start_point``.

    Returns:
        (selected_points (N, max_K, D) zero-padded,
         selected_indices (N, max_K) int64, -1-padded).

    Raises ``ValueError`` where N or P is 0, as the JAX package refuses
    those batches (``sample_farthest_points_naive`` takes them).
    """
    if points.shape[0] == 0 or points.shape[1] == 0:
        raise ValueError("sample_farthest_points needs N >= 1 clouds of P >= 1 "
                         f"points (got points of shape {tuple(points.shape)})")
    points = points.to(torch.float32).contiguous()
    lengths, K_t, max_K, starts = _prepare(
        points, lengths, K, random_start_point, generator
    )
    with torch.no_grad():
        idx = route(points)(points.detach(), lengths, K_t, starts, max_K)
    return masked_gather(points, idx), idx


@tracing.spanned("sample_farthest_points_naive")
def sample_farthest_points_naive(
    points: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    K: Union[int, List, torch.Tensor] = 50,
    random_start_point: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A numpy oracle, one cloud and one round at a time, with the same
    arguments, random starts and results as ``sample_farthest_points``."""
    points = torch.as_tensor(points).to(torch.float32)
    lengths, K_t, max_K, starts = _prepare(
        points, lengths, K, random_start_point, generator
    )
    tracing.sync("fps_naive.inputs", 4)
    pts = points.detach().cpu().numpy()
    lengths_np = lengths.cpu().numpy()
    K_np = K_t.cpu().numpy()
    starts_np = starts.cpu().numpy()
    N, _, D = pts.shape
    all_idx = np.full((N, max_K), -1, np.int64)
    for n in range(N):
        L = int(lengths_np[n])
        k_n = min(L, int(K_np[n]))
        if k_n <= 0:
            continue
        closest = np.full((L,), np.inf, np.float32)
        selected = int(starts_np[n])
        all_idx[n, 0] = selected
        for i in range(1, k_n):
            d2 = np.zeros((L,), np.float32)
            for d in range(D):
                diff = pts[n, :L, d] - pts[n, selected, d]
                d2 = d2 + diff * diff
            closest = np.minimum(closest, d2)
            selected = int(np.argmax(closest))
            all_idx[n, i] = selected
    idx = torch.from_numpy(all_idx).to(points.device)
    return masked_gather(points, idx), idx
