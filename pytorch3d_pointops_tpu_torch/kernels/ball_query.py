"""Ball query (the first K points in scan order within a radius): the Hopper
kernel ``csrc/ball_query.cu`` and its plain PyTorch twin.

``ball_query_points`` runs where its inputs are: a CUDA tensor launches the
kernel (``ball_query_cuda``), a CPU tensor takes the plain version
(``ball_query_plain``); any other device raises. Both return, for every
query, the first K columns ``j < lengths2[n]`` in ascending order whose
squared L2 distance is strictly below ``r2``, as (dists (N, P1, K) float32,
idx (N, P1, K) int64): slots past a query's hits and rows past
``lengths1[n]`` are idx -1 with distance 0.

``r2`` is the squared radius rounded to float32 once, from the radius in
double precision, as the JAX package forms it: ``squared_radius(radius)``.

The kernel replaces ``pytorch3d_pointops_tpu/kernels/ball_query_pallas.py``
``ball_query_forward_pallas``; the design note is at the top of
``csrc/ball_query.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, tracing
from .knn import pairwise_dist

# Above this many N*P1*P2 distance elements the plain version streams P2 in
# tiles instead of materialising the whole matrix.
_FULL_MATRIX_MAX_ELEMS = 32 * 1024 * 1024
_TILE_P2 = 4096
_BIG = 2**62  # key of a column outside the ball: after every real column


def squared_radius(radius: float) -> float:
    """``radius * radius`` in double, rounded to float32 once."""
    return float(np.float32(float(radius) * float(radius)))


def _first_k_in_radius(d2, in_radius, offset, K):
    """The K smallest column keys among in-radius entries of an (N, P1, T)
    tile, ascending, with their distances; ``_BIG`` keys pad the rest."""
    T = d2.shape[2]
    col = torch.arange(offset, offset + T, device=d2.device)
    key = torch.where(in_radius, col, _BIG)
    Kp = min(K, T)
    keys, sel = torch.topk(key, Kp, dim=2, largest=False, sorted=True)
    dv = torch.gather(d2, 2, sel)
    if Kp < K:
        keys = torch.nn.functional.pad(keys, (0, K - Kp), value=_BIG)
        dv = torch.nn.functional.pad(dv, (0, K - Kp))
    return keys, dv


def ball_query_plain(p1, p2, lengths1, lengths2, K: int, r2: float):
    """Plain PyTorch twin of the kernel, on any device: the full distance
    matrix for small problems, P2 tiles merged in scan order for large ones."""
    N, P1, _ = p1.shape
    P2 = p2.shape[1]
    dev = p1.device
    i_valid = torch.arange(P1, device=dev)[None, :, None] < lengths1[:, None, None]
    # max(P2, 1): with no candidate the loop runs no tile and every slot
    # stays padding.
    tile = max(P2, 1) if N * P1 * P2 <= _FULL_MATRIX_MAX_ELEMS else _TILE_P2
    keys = torch.full((N, P1, K), _BIG, dtype=torch.int64, device=dev)
    dists = p1.new_zeros((N, P1, K))
    for off in range(0, P2, tile):
        d2 = pairwise_dist(p1, p2[:, off : off + tile], 2)
        j = torch.arange(off, off + d2.shape[2], device=dev)
        in_radius = (d2 < r2) & (j[None, None, :] < lengths2[:, None, None]) & i_valid
        kk, dv = _first_k_in_radius(d2, in_radius, off, K)
        if off == 0:
            keys, dists = kk, dv
            continue
        # Every key of this tile is above every real key so far: the merge
        # is the first K of the concatenation in key order.
        keys, sel = torch.topk(torch.cat([keys, kk], 2), K, dim=2, largest=False,
                               sorted=True)
        dists = torch.gather(torch.cat([dists, dv], 2), 2, sel)
    valid = keys < _BIG
    return torch.where(valid, dists, 0.0), torch.where(valid, keys, -1)


def _check_inputs(p1, p2, lengths1, lengths2, K):
    if K < 1:
        raise ValueError(f"K must be >= 1 (got {K})")
    if p1.dim() != 3 or p2.dim() != 3 or p1.shape[0] != p2.shape[0]:
        raise ValueError("p1 and p2 must be (N, P1, D) and (N, P2, D)")
    if p1.shape[2] != p2.shape[2]:
        raise ValueError("p1 and p2 must have the same point dimension")
    if lengths1.shape != (p1.shape[0],) or lengths2.shape != (p1.shape[0],):
        raise ValueError("lengths1 and lengths2 must be of shape (N,)")


def _entry():
    fn = _build.load("ball_query").ball_query
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def ball_query_cuda(p1, p2, lengths1, lengths2, K: int, r2: float):
    """Launch ``csrc/ball_query.cu`` on CUDA tensors: float32 points, int64
    lengths, all contiguous and on one device; any K in one launch."""
    _check_inputs(p1, p2, lengths1, lengths2, K)
    for t, dtype in ((p1, torch.float32), (p2, torch.float32),
                     (lengths1, torch.int64), (lengths2, torch.int64)):
        if not t.is_cuda or t.device != p1.device:
            raise ValueError("ball_query_cuda needs every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"ball_query_cuda needs contiguous {dtype} inputs")
    N, P1, D = p1.shape
    dists = torch.empty((N, P1, K), dtype=torch.float32, device=p1.device)
    idx = torch.empty((N, P1, K), dtype=torch.int64, device=p1.device)
    _build.check(
        _entry()(p1.data_ptr(), p2.data_ptr(), lengths1.data_ptr(),
                 lengths2.data_ptr(), N, P1, p2.shape[1], D, K, r2,
                 dists.data_ptr(), idx.data_ptr(), _build.stream_ptr(p1.device)),
        "ball_query",
    )
    tracing.launch("ball_query_cuda")
    return dists, idx


@tracing.spanned("ball_query_points")
def ball_query_points(p1, p2, lengths1, lengths2, K: int, r2: float):
    """The first K points of ``p2`` within squared radius ``r2`` of every
    query in ``p1``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if p1.is_cuda:
        return ball_query_cuda(p1, p2, lengths1, lengths2, K, r2)
    if p1.device.type == "cpu":
        _check_inputs(p1, p2, lengths1, lengths2, K)
        return ball_query_plain(p1, p2, lengths1, lengths2, K, r2)
    raise ValueError(f"ball_query_points: no kernel for device {p1.device}")
