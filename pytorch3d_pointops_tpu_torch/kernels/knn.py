"""Brute-force KNN top-K: the Hopper kernel ``csrc/knn.cu`` and its plain
PyTorch twin.

``knn_topk`` runs where its inputs are: a CUDA tensor launches the kernel
(``knn_topk_cuda``), a CPU tensor takes the plain version
(``knn_topk_plain``); any other device raises. Both return, for every query,
the K smallest squared-L2 (norm 2) or L1 (norm 1) distances to the first
``lengths2[n]`` points of its cloud, in ascending (value, index) order (on
ties the lowest index wins), with int64 indices. Slots past ``lengths2`` and
rows past ``lengths1`` are not zeroed here: callers apply the pad
conventions (``ops.knn._apply_pad_conventions``).

The kernel replaces ``pytorch3d_pointops_tpu/kernels/knn_pallas.py``
``knn_forward_pallas``; the design note is at the top of ``csrc/knn.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# Keys per kernel round; K > ROUND_K chains rounds behind an exclusive
# (value, index) lower bound, as the TPU kernel does.
ROUND_K = 64

# Above this many N*P1*P2 distance elements the plain version streams P2 in
# tiles instead of materialising the whole matrix.
_FULL_MATRIX_MAX_ELEMS = 32 * 1024 * 1024
_TILE_P1 = 2048
_TILE_P2 = 2048

_INF = float("inf")


def pairwise_dist(x: torch.Tensor, y: torch.Tensor, norm: int) -> torch.Tensor:
    """(..., P1, D) x (..., P2, D) -> (..., P1, P2) squared-L2 or L1
    distances, accumulated axis by axis in order d = 0..D-1 (no matrix
    product at any D, so no TF32 and no |x|^2 + |y|^2 - 2xy cancellation)."""
    if norm not in (1, 2):
        raise ValueError("Support for 1 or 2 norm.")
    d = x.new_zeros((*x.shape[:-1], y.shape[-2]))
    for di in range(x.shape[-1]):
        diff = x[..., di, None] - y[..., None, :, di]
        d = d + (diff * diff if norm == 2 else diff.abs())
    return d


def _topk_rows(d: torch.Tensor, idx: torch.Tensor, K: int):
    """First K entries of each row in (value, index) order. ``idx`` must
    ascend along each row among equal values (a stable sort keeps it)."""
    vals, order = torch.sort(d, dim=-1, stable=True)
    return vals[..., :K], torch.gather(idx, -1, order[..., :K])


def _knn_forward_full(p1, p2, lengths2, K, norm):
    """Single-shot distance matrix and a stable sort (small problems)."""
    P2 = p2.shape[1]
    d = pairwise_dist(p1, p2, norm)
    j = torch.arange(P2, device=p1.device)
    d = torch.where(j[None, None, :] < lengths2[:, None, None], d, _INF)
    vals, idx = _topk_rows(d, j.expand_as(d), min(K, P2))
    if K > P2:
        vals = torch.nn.functional.pad(vals, (0, K - P2), value=_INF)
        idx = torch.nn.functional.pad(idx, (0, K - P2))
    return vals, idx


def _knn_single_tiled(x, y, len2, K, norm, tile_p2):
    """Streaming KNN for one cloud: scan tiles of y and merge a running
    top-K. Carried entries go first, so ties keep the earlier index."""
    C1 = x.shape[0]
    cd = x.new_full((C1, K), _INF)
    ci = torch.zeros((C1, K), dtype=torch.int64, device=x.device)
    for off in range(0, y.shape[0], tile_p2):
        yt = y[off : off + tile_p2]
        j = torch.arange(off, off + yt.shape[0], device=x.device)
        d = pairwise_dist(x, yt, norm)
        d = torch.where(j[None, :] < len2, d, _INF)
        cd, ci = _topk_rows(
            torch.cat([cd, d], dim=1),
            torch.cat([ci, j.expand(C1, -1)], dim=1),
            K,
        )
    return cd, ci


def _knn_forward_tiled(p1, p2, lengths2, K, norm):
    """Tiled streaming forward for large problems: P1 in chunks, P2 in
    tiles, one cloud at a time."""
    N, P1, _ = p1.shape
    vals = p1.new_empty((N, P1, K))
    idx = torch.empty((N, P1, K), dtype=torch.int64, device=p1.device)
    for n in range(N):
        for a in range(0, P1, _TILE_P1):
            vals[n, a : a + _TILE_P1], idx[n, a : a + _TILE_P1] = (
                _knn_single_tiled(
                    p1[n, a : a + _TILE_P1], p2[n], lengths2[n], K, norm,
                    _TILE_P2,
                )
            )
    return vals, idx


def knn_topk_plain(p1, p2, lengths2, K: int, norm: int):
    """Plain PyTorch twin of the kernel, on any device: the full distance
    matrix for small problems, the tiled stream for large ones."""
    N, P1, _ = p1.shape
    if N * P1 * p2.shape[1] <= _FULL_MATRIX_MAX_ELEMS:
        return _knn_forward_full(p1, p2, lengths2, K, norm)
    return _knn_forward_tiled(p1, p2, lengths2, K, norm)


def _entry():
    lib = _build.load("knn")
    fn = lib.knn_topk
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(p1, p2, lengths2, K, norm):
    if norm not in (1, 2):
        raise ValueError("Support for 1 or 2 norm.")
    if K < 1:
        raise ValueError(f"K must be >= 1 (got {K})")
    if p1.dim() != 3 or p2.dim() != 3 or p1.shape[0] != p2.shape[0]:
        raise ValueError("p1 and p2 must be (N, P1, D) and (N, P2, D)")
    if p1.shape[2] != p2.shape[2]:
        raise ValueError("p1 and p2 must have the same point dimension")
    if lengths2.shape != (p1.shape[0],):
        raise ValueError("lengths2 must be of shape (N,)")


def knn_topk_cuda(p1, p2, lengths2, K: int, norm: int):
    """Launch ``csrc/knn.cu`` on CUDA tensors: float32 points, int64
    lengths, all contiguous and on one device. K > 64 runs ceil(K/64)
    chained rounds. Returns (dists (N, P1, K) float32, idx (N, P1, K) int64),
    (inf, 0) in slots past ``lengths2``."""
    _check_inputs(p1, p2, lengths2, K, norm)
    for t, dtype in ((p1, torch.float32), (p2, torch.float32),
                     (lengths2, torch.int64)):
        if not t.is_cuda or t.device != p1.device:
            raise ValueError("knn_topk_cuda needs every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"knn_topk_cuda needs contiguous {dtype} inputs")
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    fn = _entry()
    stream = _build.stream_ptr(p1.device)

    def launch(k, lb_d, lb_i):
        d = torch.empty((N, P1, k), dtype=torch.float32, device=p1.device)
        i = torch.empty((N, P1, k), dtype=torch.int64, device=p1.device)
        _build.check(
            fn(p1.data_ptr(), p2.data_ptr(), lengths2.data_ptr(),
               None if lb_d is None else lb_d.data_ptr(),
               None if lb_i is None else lb_i.data_ptr(),
               N, P1, P2, D, k, norm, d.data_ptr(), i.data_ptr(), stream),
            "knn_topk",
        )
        knn_topk_cuda.launches += 1
        return d, i

    if K <= ROUND_K:
        return launch(K, None, None)
    # Rounds past ceil(min(K, P2) / 64) cannot admit anything.
    rounds = max(1, -(-min(K, P2) // ROUND_K))
    ds, idxs = [], []
    lb_d = lb_i = None
    for _ in range(rounds):
        d, i = launch(ROUND_K, lb_d, lb_i)
        ds.append(d)
        idxs.append(i)
        lb_d, lb_i = d[..., -1].contiguous(), i[..., -1].contiguous()
    d, i = torch.cat(ds, dim=2), torch.cat(idxs, dim=2)
    if d.shape[2] < K:
        d = torch.nn.functional.pad(d, (0, K - d.shape[2]), value=_INF)
        i = torch.nn.functional.pad(i, (0, K - i.shape[2]))
    return d[..., :K].contiguous(), i[..., :K].contiguous()


knn_topk_cuda.launches = 0


def knn_topk(p1, p2, lengths2, K: int, norm: int):
    """The K nearest of the first ``lengths2[n]`` points of ``p2`` for every
    query in ``p1``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if p1.is_cuda:
        return knn_topk_cuda(p1, p2, lengths2, K, norm)
    if p1.device.type == "cpu":
        _check_inputs(p1, p2, lengths2, K, norm)
        return knn_topk_plain(p1, p2, lengths2, K, norm)
    raise ValueError(f"knn_topk: no kernel for device {p1.device}")
