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
Each launch takes a ``Plan`` (queries a thread, threads a block, candidates
a staged tile) that ``_launch_plan`` picks from the shapes, the card's SM
count and how many blocks of the kernel fit on an SM;
``python -m pytorch3d_pointops_tpu_torch.tune_knn`` times every feasible
plan on the card.

Morton sorting, the JAX kernel's ``sort_queries`` and ``sort_candidates``
(``kernels/spatial_sort.py``): the kernel takes the queries in Morton order
and its outputs are put back in row order, which changes no bit of them;
candidates are sorted once for every chained round and carry their
original indices into the kernel, which scans each block's tiles from the
one nearest its queries and breaks ties by original index, so the results
are the same again. ``None`` means the measured auto gate (``sort_gates``); ``True`` on
CPU tensors runs the same permutations around the plain version, whose
ties are then broken by the carried indices too. ``instrument=True`` also
returns the kernel's per-block counters (``COUNTERS``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from .. import _build
from . import spatial_sort as _ss

# Keys per kernel round; K > ROUND_K chains rounds behind an exclusive
# (value, index) lower bound, as the TPU kernel does.
ROUND_K = 64

# Block sizes a plan may take (csrc/knn.cu: multiples of 32, at most 256).
_THREADS = (32, 64, 128, 256)
# Distances a thread holds between two votes, Q queries x 16/Q candidates
# (csrc/knn.cu kGroupSlots); tiles are whole groups.
_GROUP_SLOTS = 16
# Shared memory a block stages without opting in (two tiles).
_SMEM_DEFAULT = 48 * 1024

# The per-block counters of an instrumented launch, in order (csrc/knn.cu
# COUNT): groups scanned and votes fired (a warp's), drains with work (a
# warp's), insertions into the top-K and candidates that passed the vote's
# screen into a pending list (a query's).
COUNTERS = ("groups", "fired", "drains", "admissions", "screened")

# The auto gate of query sorting (None): the fewest N*P1*P2 pairs at which
# the queries are sorted, by K bucket of one round (none below 16: slower at
# every shape). From tune_knn.py on an H100 80GB HBM3 at 700 W (PERF.md):
# the sort costs 0.2-0.9 ms of small launches and saves 10-24 % of the
# kernel, more at larger K; at the 64-key bucket and chained rounds it won
# at every shape from 2.5e9 pairs, at the 32-key one from 6.4e9, and at the
# 16-key one at config 4 (1e12) but within noise up to the north star
# (1e10), so that threshold is interpolated.
SORT_QUERIES_MIN_PAIRS = {16: 10**11, 32: 6 * 10**9, 64: 2 * 10**9}


class Plan(NamedTuple):
    """One launch of ``csrc/knn.cu``: ``queries`` a thread (1 or 2),
    ``threads`` a block, ``tile`` candidates a staged tile."""

    queries: int
    threads: int
    tile: int


def plan_name(plan: Plan) -> str:
    return f"q{plan.queries}/t{plan.threads}/tile{plan.tile}"


def _bucket(K: int) -> int:
    """The kernel's K bucket (1, 2, 4, ..., 64) for one round of K keys."""
    kb = 1
    while kb < min(K, ROUND_K):
        kb *= 2
    return kb


def _max_queries(K: int, D: int) -> int:
    """Queries a thread may own: two up to the 16-key bucket (the top-K
    state is 2 * KB registers a query), one above it and at D > 8."""
    return 2 if D <= 8 and _bucket(K) <= 16 else 1


def _tiles(P2: int, D: int) -> tuple[int, ...]:
    """Tile sizes a plan may stage at D, the default first: candidates
    padded to 4 floats (D=3) or 8 (D<=8), two tiles in at most 48 KB;
    never longer than P2 rounded up to whole groups."""
    if D == 3:
        sizes = (1024, 512, 256)
    elif D <= 8:
        sizes = (512, 256, 128)
    else:
        t = max(1, _SMEM_DEFAULT // (2 * 4 * D))
        sizes = (t - t % _GROUP_SLOTS if t >= _GROUP_SLOTS else t,)
    cap = -(-max(P2, 1) // _GROUP_SLOTS) * _GROUP_SLOTS
    return tuple(dict.fromkeys(min(s, cap) for s in sizes))


def _blocks(N: int, P1: int, plan: Plan) -> int:
    return N * -(-P1 // (plan.queries * plan.threads))


def _plan_cost(N, P1, D, plan: Plan, sm_count: int, resident: int) -> float:
    """Modelled issue time of the busiest SM scheduler, in warp instructions
    per candidate: blocks spread evenly over the SMs, at most ``resident``
    of them at once; their warps spread evenly over the SM's 4 schedulers;
    a warp issues 3*D operations per query per candidate, its candidate
    loads and D/T copies to stage it; a scheduler with one warp at a time
    issues at 3/4 of its rate. Fitted to ``tune_knn.py``'s times on an
    H100 80GB HBM3 at 700 W, where the plan it picks came within 10 % of
    the fastest plan at every shape and K (PERF.md)."""
    Q, T = plan.queries, plan.threads
    per_sm = -(-_blocks(N, P1, plan) // sm_count)
    at_once = max(1, min(per_sm, resident))
    warps = -(-(per_sm * T // 32) // 4)
    concurrent = -(-(at_once * T // 32) // 4)
    loads = -(-D // 4) if D <= 8 else D
    per_warp = Q * 3 * D + loads + D / T
    return warps * per_warp / min(1.0, 0.75 * concurrent)


def feasible_plans(N, P1, P2, D, K, resident: Callable[[Plan], int]) -> list[Plan]:
    """Every plan the kernel takes for one round of min(K, 64) keys at these
    shapes, with at least one block resident on an SM."""
    plans = [Plan(q, t, tile) for q in (1, 2) if q <= _max_queries(K, D)
             for t in _THREADS for tile in _tiles(P2, D)]
    return [p for p in plans if resident(p) >= 1]


def _launch_plan(N, P1, P2, D, K, sm_count: int,
                 resident: Callable[[Plan], int]) -> Plan:
    """The plan ``knn_topk_cuda`` launches: the default tile, Q = 1 where a
    larger Q would leave fewer blocks than SMs even at 32 threads, then the
    least ``_plan_cost``; on ties the larger block, then the smaller Q."""
    tile = _tiles(P2, D)[0]
    plans = [p for p in feasible_plans(N, P1, P2, D, K, resident) if p.tile == tile]
    plans = [p for p in plans
             if p.queries == 1 or _blocks(N, P1, Plan(p.queries, 32, tile)) >= sm_count]
    if not plans:
        raise RuntimeError(f"knn_topk: no launch plan fits the card (D={D}, K={K})")
    return min(plans, key=lambda p: (
        _plan_cost(N, P1, D, p, sm_count, resident(p)), -p.threads, p.queries))


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


def _topk_rows(d: torch.Tensor, idx: torch.Tensor, K: int, lex: bool = False):
    """First K entries of each row in (value, index) order. Without ``lex``,
    ``idx`` must ascend along each row among equal values (a stable sort
    keeps it); with it, the rows are put in index order first."""
    if lex:
        by_idx = torch.argsort(idx, dim=-1, stable=True)
        d, idx = torch.gather(d, -1, by_idx), torch.gather(idx, -1, by_idx)
    vals, order = torch.sort(d, dim=-1, stable=True)
    return vals[..., :K], torch.gather(idx, -1, order[..., :K])


def _knn_forward_full(p1, p2, lengths2, K, norm, ids=None):
    """Single-shot distance matrix and a stable sort (small problems).
    ``ids``: each p2 row's original index (int64), when p2 is reordered."""
    P2 = p2.shape[1]
    d = pairwise_dist(p1, p2, norm)
    j = torch.arange(P2, device=p1.device)
    d = torch.where(j[None, None, :] < lengths2[:, None, None], d, _INF)
    idx = j.expand_as(d) if ids is None else ids[:, None, :].expand_as(d)
    vals, idx = _topk_rows(d, idx, min(K, P2), lex=ids is not None)
    if K > P2:
        vals = torch.nn.functional.pad(vals, (0, K - P2), value=_INF)
        idx = torch.nn.functional.pad(idx, (0, K - P2))
    return vals, idx


def _knn_single_tiled(x, y, len2, K, norm, tile_p2, ids=None):
    """Streaming KNN for one cloud: scan tiles of y and merge a running
    top-K. Carried entries go first, so ties keep the earlier index (with
    ``ids``, y's original indices, ties are broken by those)."""
    C1 = x.shape[0]
    cd = x.new_full((C1, K), _INF)
    ci = torch.zeros((C1, K), dtype=torch.int64, device=x.device)
    for off in range(0, y.shape[0], tile_p2):
        yt = y[off : off + tile_p2]
        pos = torch.arange(off, off + yt.shape[0], device=x.device)
        j = pos if ids is None else ids[off : off + yt.shape[0]]
        d = pairwise_dist(x, yt, norm)
        d = torch.where(pos[None, :] < len2, d, _INF)
        cd, ci = _topk_rows(
            torch.cat([cd, d], dim=1),
            torch.cat([ci, j.expand(C1, -1)], dim=1),
            K,
            lex=ids is not None,
        )
    return cd, ci


def _knn_forward_tiled(p1, p2, lengths2, K, norm, ids=None):
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
                    _TILE_P2, None if ids is None else ids[n],
                )
            )
    return vals, idx


def knn_topk_plain(p1, p2, lengths2, K: int, norm: int, cand_ids=None):
    """Plain PyTorch twin of the kernel, on any device: the full distance
    matrix for small problems, the tiled stream for large ones. With
    ``cand_ids`` (N, P2), p2 is reordered (its valid rows first) and
    ``cand_ids`` holds each row's original index: the indices returned are
    those, ties broken by them, as the kernel's carried instances do."""
    N, P1, _ = p1.shape
    ids = None if cand_ids is None else cand_ids.to(torch.int64)
    if N * P1 * p2.shape[1] <= _FULL_MATRIX_MAX_ELEMS:
        return _knn_forward_full(p1, p2, lengths2, K, norm, ids)
    return _knn_forward_tiled(p1, p2, lengths2, K, norm, ids)


@functools.cache
def _lib():
    lib = _build.load("knn")
    lib.knn_topk.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.knn_resident_blocks.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    for fn in (lib.knn_topk, lib.knn_resident_blocks):
        fn.restype = ctypes.c_int
    return lib


def _carried_instance(D: int, K: int, norm: int) -> bool:
    """Whether ``csrc/knn.cu`` has candidate-sorted (carried) instances for
    D, K and norm (its pick_mode): D = 3 and a K bucket of 8 or more, at
    norm 1 not the 32-key bucket (17 <= K <= 32)."""
    return D == 3 and _bucket(K) >= 8 and (norm == 2 or _bucket(K) != 32)


def _counted_instance(D: int, K: int, norm: int) -> bool:
    """Whether it has counting instances: D = 3, norm 2, a single round of
    a K bucket of 8 or more."""
    return _carried_instance(D, K, norm) and norm == 2 and K <= ROUND_K


@functools.lru_cache(maxsize=None)
def _resident(device: int, K: int, D: int, norm: int, plan: Plan,
              carried: bool = False) -> int:
    """Blocks of the kernel instance for (K, D, norm, plan, carried) that
    fit on one SM of CUDA device ``device`` (registers, shared memory,
    threads)."""
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        _build.check(
            _lib().knn_resident_blocks(K, D, norm, plan.queries, plan.threads,
                                       plan.tile, int(carried), 0,
                                       ctypes.byref(blocks)),
            "knn_resident_blocks",
        )
    return blocks.value


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _card_plan(device: int, N, P1, P2, D, K, norm, carried=False) -> Plan:
    return _launch_plan(N, P1, P2, D, K, _sm_count(device),
                        lambda plan: _resident(device, K, D, norm, plan, carried))


def card_plans(p1, p2, K: int, norm: int, carried: bool = False
               ) -> tuple[Plan, list[Plan]]:
    """(the plan ``knn_topk_cuda`` picks, every feasible plan) for one round
    of these CUDA inputs on their card, for the instances that take p2 in
    index order or, with ``carried``, sorted."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    k = min(K, ROUND_K)
    dev = p1.device.index
    return (_card_plan(dev, N, P1, P2, D, k, norm, carried),
            feasible_plans(N, P1, P2, D, k,
                           lambda plan: _resident(dev, k, D, norm, plan, carried)))


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


def sort_gates(pairs: int, K: int, on_cuda: bool, sort_queries=None,
               sort_candidates=None) -> tuple[bool, bool]:
    """(sort the queries, sort the candidates) for a call over ``pairs`` =
    N * P1 * P2 query-candidate pairs: an explicit choice stands; ``None``
    takes the auto gate, off on CPU tensors: the queries where the card
    measured the sort faster (``SORT_QUERIES_MIN_PAIRS``), the candidates
    never (slower at every shape the card measured, PERF.md)."""
    if sort_queries is None:
        least = SORT_QUERIES_MIN_PAIRS.get(_bucket(K))
        sort_queries = on_cuda and least is not None and pairs >= least
    return bool(sort_queries), bool(sort_candidates)


class CandidateOrder(NamedTuple):
    """p2 in Morton order on the joint box of p1 and p2's valid rows, rows
    past lengths2 last: ``points`` (N, P2, D), ``ids`` (N, P2) int32 each
    row's original index, ``codes`` (N, P2) int32 its code (ascending),
    ``lo``/``hi`` (N, 1, 3) the box."""

    points: torch.Tensor
    ids: torch.Tensor
    codes: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def candidate_order(p1, p2, lengths2) -> CandidateOrder:
    """Sort the candidates once, for every chained round. Valid rows take
    their Morton code on the joint box, rows past ``lengths2`` ``PAD_CODE``,
    above every code, so that they sort past the valid ones and a
    truncation by position still drops them."""
    N, P2, D = p2.shape
    valid = torch.arange(P2, device=p2.device)[None, :] < lengths2[:, None]
    xyz1, xyz2 = p1[..., :3], p2[..., :3]
    lo = torch.minimum(xyz1.amin(dim=1, keepdim=True), torch.where(
        valid[..., None], xyz2, _INF).amin(dim=1, keepdim=True))
    hi = torch.maximum(xyz1.amax(dim=1, keepdim=True), torch.where(
        valid[..., None], xyz2, -_INF).amax(dim=1, keepdim=True))
    codes = torch.where(valid, _ss.morton_code(p2, lo, hi), _ss.PAD_CODE)
    codes, order = torch.sort(codes, dim=1, stable=True)
    points = torch.gather(p2, 1, order[..., None].expand(N, P2, D))
    return CandidateOrder(points, order.to(torch.int32), codes, lo, hi)


def scan_starts(p1, order: CandidateOrder, block: int, tile: int,
                rows=None) -> torch.Tensor:
    """(N, ceil(P1 / block)) int32: for each block of ``block`` consecutive
    queries (in the order ``rows``, if given), the tile of sorted candidates
    to scan first, the one whose first code is the last at or below the
    Morton code of the block's median query (knn_pallas.py's per-block start
    tiles). A poor start costs time, never results: every tile is still
    scanned once."""
    N, P1, _ = p1.shape
    P2 = order.codes.shape[1]
    dev = p1.device
    n_tiles = max(1, -(-P2 // tile))
    bpos = (torch.arange(n_tiles, device=dev) * tile).clamp(max=P2 - 1)
    bounds = order.codes[:, bpos].contiguous()
    mpos = (torch.arange(-(-P1 // block), device=dev) * block + block // 2).clamp(
        max=P1 - 1)
    med = p1[:, mpos] if rows is None else _gather_rows(p1, rows[:, mpos])
    med = _ss.morton_code(med, order.lo, order.hi).contiguous()
    starts = torch.searchsorted(bounds, med, right=True) - 1
    return starts.clamp(0, n_tiles - 1).to(torch.int32).contiguous()


def _gather_rows(x, rows):
    """x[n, rows[n]] for (N, P, ...) x and (N, R) rows."""
    return torch.gather(x, 1, rows.reshape(*rows.shape, *[1] * (x.dim() - 2))
                        .expand(*rows.shape, *x.shape[2:]))


def _unpermute(x, rows):
    """The inverse of ``_gather_rows(., rows)`` for a permutation ``rows``:
    row i of (N, P, ...) x goes back to row rows[n, i]."""
    index = rows.reshape(*rows.shape, *[1] * (x.dim() - 2)).expand_as(x)
    return torch.empty_like(x).scatter_(1, index, x)


def _with_sorting(p1, p2, lengths2, sort_queries, sort_candidates, topk):
    """``topk(p1, p2, order, rows)`` with the candidates sorted (``order`` a
    ``CandidateOrder`` whose points are p2, else None) and the queries'
    Morton order (``rows``, (N, P1) int64, else None), as asked."""
    if p1.shape[1] == 0 or p2.shape[1] == 0:  # nothing to order
        return topk(p1, p2, None, None)
    order = candidate_order(p1, p2, lengths2) if sort_candidates else None
    rows = _ss.morton_order(p1) if sort_queries else None
    return topk(p1, p2 if order is None else order.points, order, rows)


def _launch_rounds(p1, p2, lengths2, K, norm, plan: Plan, rows=None,
                   cand_ids=None, starts=None, counts=None):
    """The kernel's launches for one call: one round, or ceil(K/64) chained
    64-key rounds behind each query's (value, index) lower bound. ``rows``
    (int32): the order the kernel takes the queries in, and its outputs'
    row order; ``cand_ids`` and ``starts`` (int32): p2's original indices
    and each block's first tile."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    dev = p1.device
    fn = _lib().knn_topk
    stream = _build.stream_ptr(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch(k, lb_d, lb_i):
        d = torch.empty((N, P1, k), dtype=torch.float32, device=dev)
        i = torch.empty((N, P1, k), dtype=torch.int64, device=dev)
        _build.check(
            fn(p1.data_ptr(), p2.data_ptr(), lengths2.data_ptr(), ptr(lb_d),
               ptr(lb_i), ptr(rows), ptr(cand_ids), ptr(starts), ptr(counts),
               N, P1, P2, D, k, norm, *plan, d.data_ptr(), i.data_ptr(), stream),
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


def knn_topk_cuda(p1, p2, lengths2, K: int, norm: int, *, sort_queries=None,
                  sort_candidates=None, instrument: bool = False,
                  _plan: Plan | None = None):
    """Launch ``csrc/knn.cu`` on CUDA tensors: float32 points, int64
    lengths, all contiguous and on one device. K > 64 runs ceil(K/64)
    chained rounds. Returns (dists (N, P1, K) float32, idx (N, P1, K) int64),
    (inf, 0) in slots past ``lengths2``; with ``instrument``, also the
    (N, blocks, 5) int64 counters of ``COUNTERS`` per block of the launch
    (the blocks of the sorted queries, if sorted).

    ``sort_queries`` / ``sort_candidates``: Morton-sort the queries / the
    candidates (None: ``sort_gates``). Sorted candidates need the carried
    instances (D = 3, K >= 5; at norm 1 not 17 <= K <= 32), counters the counting ones (D = 3, norm 2,
    5 <= K <= 64): asked for elsewhere, they raise. ``_plan`` forces a
    launch plan (``tune_knn.py``); by default ``_launch_plan`` picks it."""
    _check_inputs(p1, p2, lengths2, K, norm)
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    sort_queries, sort_candidates = sort_gates(N * P1 * P2, K, True, sort_queries,
                                               sort_candidates)
    if sort_candidates and not _carried_instance(D, K, norm):
        raise ValueError(f"knn_topk_cuda: no candidate-sorted kernel for D={D}, "
                         f"K={K}, norm={norm} (D = 3 and K >= 5 only; at norm 1 "
                         "not 17 <= K <= 32)")
    if instrument and not _counted_instance(D, K, norm):
        raise ValueError(f"knn_topk_cuda: no counting kernel for D={D}, K={K}, "
                         f"norm={norm} (D = 3, norm 2, 5 <= K <= 64 only)")
    dev = p1.device
    for t, dtype in ((p1, torch.float32), (p2, torch.float32),
                     (lengths2, torch.int64)):
        if not t.is_cuda or t.device != dev:
            raise ValueError("knn_topk_cuda needs every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"knn_topk_cuda needs contiguous {dtype} inputs")
    plan = _plan or _card_plan(dev.index, N, P1, P2, D, min(K, ROUND_K), norm,
                               sort_candidates)
    block = plan.queries * plan.threads
    counts = (torch.zeros((N, -(-P1 // block), len(COUNTERS)), dtype=torch.int64,
                          device=dev) if instrument else None)

    def topk(q, ref, order, rows):
        rows32 = None if rows is None else rows.to(torch.int32)
        if order is None:
            d, i = _launch_rounds(q, ref, lengths2, K, norm, plan, rows32,
                                  counts=counts)
        else:
            d, i = _launch_rounds(q, ref, lengths2, K, norm, plan, rows32,
                                  order.ids, scan_starts(q, order, block, plan.tile,
                                                         rows), counts)
        return (d, i) if rows is None else (_unpermute(d, rows), _unpermute(i, rows))

    d, i = _with_sorting(p1, p2, lengths2, sort_queries, sort_candidates, topk)
    return (d, i, counts) if instrument else (d, i)


knn_topk_cuda.launches = 0


def _plain_sorted(p1, p2, lengths2, K, norm, order, rows):
    """The plain twin on sorted inputs: the queries taken in the order
    ``rows`` and their outputs put back in row order."""
    ids = None if order is None else order.ids
    if rows is None:
        return knn_topk_plain(p1, p2, lengths2, K, norm, ids)
    d, i = knn_topk_plain(_gather_rows(p1, rows), p2, lengths2, K, norm, ids)
    return _unpermute(d, rows), _unpermute(i, rows)


def knn_topk(p1, p2, lengths2, K: int, norm: int, *, sort_queries=None,
             sort_candidates=None):
    """The K nearest of the first ``lengths2[n]`` points of ``p2`` for every
    query in ``p1``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors, each with the Morton sorts asked for (None: the auto
    gate, which is off on the CPU)."""
    if p1.is_cuda:
        return knn_topk_cuda(p1, p2, lengths2, K, norm, sort_queries=sort_queries,
                             sort_candidates=sort_candidates)
    if p1.device.type == "cpu":
        _check_inputs(p1, p2, lengths2, K, norm)
        N, P1, _ = p1.shape
        sq, sc = sort_gates(N * P1 * p2.shape[1], K, False, sort_queries,
                            sort_candidates)
        return _with_sorting(
            p1, p2, lengths2, sq, sc,
            lambda q, ref, order, rows: _plain_sorted(q, ref, lengths2, K, norm,
                                                      order, rows))
    raise ValueError(f"knn_topk: no kernel for device {p1.device}")
