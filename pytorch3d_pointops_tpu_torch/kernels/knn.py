"""Brute-force KNN top-K: the Hopper kernel ``csrc/knn.cu`` and its plain
PyTorch twin.

``knn_topk`` runs where its inputs are: a CUDA tensor launches the kernel
(``knn_topk_cuda``), a CPU tensor takes the plain version
(``knn_topk_plain``); any other device raises. Both return, for every query,
the K smallest squared-L2 (norm 2) or L1 (norm 1) distances to the first
``lengths2[n]`` points of its cloud, in ascending (value, index) order (on
ties the lowest index wins), with int64 indices. Slots past ``lengths2`` and
rows past ``lengths1`` are not zeroed here: callers apply the pad
conventions (``ops.knn._apply_pad_conventions``); an entry whose value is
+inf has index 0 on both paths.

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

Kth-bound seeding, the JAX kernel's ``sample_bound`` (``knn_pallas.py``
``_bigk_round_bounds``, ``_repair_sentinels``): one KNN over a strided
sample of each cloud gives every round a per-query upper bound on its
closing quantile (``kth_bounds``), and each round's top-K state starts at
that bound with ``SENT`` indices, so a query inserts only the candidates
below it. A ``SENT`` left in a slot the cloud could fill means a bound was
too tight: that is detected on the device, and every round reruns
unseeded, gated on the detection (per-query flags), so there is no host sync and the
result is the unseeded one bit for bit. Slots past ``lengths2`` then hold
(inf, 0), as unseeded (JAX's raw output keeps the seed value there). The
order is: one query sort and one candidate sort, then the sample pass in
the queries' order, the seeded rounds and the repair. ``None`` means the
measured gate (``seed_gate``); ``ub=`` seeds one round from a bound the
caller gives and returns the raw state, ``SENT`` slots included.

Screen and select (a seeded call of more than one round, K > 64; no TPU
counterpart): the sample pass gives one bound a query, that of the call's
last quantile; the screen kernel lists every candidate below its query's
seed as a 64-bit key (``screen_keys``) in a list of ``screen_cap``
entries, and the select kernel reads the K smallest keys off the list into
the rounds' outputs (``_screener``; ``_plain_screener`` on the CPU). A
query whose list may lack one of its K nearest (fewer entries than min(K,
lengths2), more than the list holds, no finite seed) is flagged, and the
chained rounds rerun unseeded for the flagged queries (``_screened``).

The screen's skip (D = 3): a query lists about 0.5 % of a 100k-point cloud,
so the screen of a D=3 call runs on its own order of the candidates
(``screen_order_cuda``, one launch a call; ``screen_order_plain``): sorted
by a coarse Morton cell code, with their original indices and one bounding
box per ``_SEGMENT`` = 128 of them over their valid rows. The warps of a
block share 32 or 64 queries, consecutive in the queries' Morton order,
and scan only the segments one of them may need: those whose bound
(``segment_bound``: the gap to the box per axis, squared, summed with the
rounding steps of the distance) is below the query's seed. Rounding to
nearest is monotone, so the bound is at most the distance of every point in
the box, and a candidate is listed only below the seed: a skipped segment
holds nothing a list would keep. So every list holds the keys and the count
of a full scan, and the outputs and flags are the same bit for bit. The
sample pass and the repair keep the unsorted cloud.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
from typing import Callable, NamedTuple

import torch

from .. import _build, tracing
from . import spatial_sort as _ss

logger = logging.getLogger(__name__)

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

# The index of a seed entry (csrc/knn.cu kSent, knn_pallas.py _SENT): a
# slot still holding it was never filled below the seed.
SENT = 2**31 - 1

# Sampled kth bounds (knn_pallas.py's constants, so the bounds are the same
# numbers): round r is seeded at the m_r-th smallest distance of an s-point
# sample, m_r = ceil(mu + SIGMA * sqrt(mu) + ABS) with mu = s * kq_r /
# lengths2 the expected sample count below the round's closing quantile
# kq_r. The margin only sets how often the repair runs; results never
# depend on it.
_BOUND_MARGIN_SIGMA = 6.0
_BOUND_MARGIN_ABS = 8.0
# The deepest sample rank a bound may take.
_MAX_RANK = 512

# Screen and select (seeded calls of more than one round): a query's list
# holds a multiple of _LIST_STEP entries, the fewest at which a query of a
# full cloud overflows with probability at most _OVERFLOW_P (screen_cap);
# the lists of one launch take at most _LIST_BYTES (queries in chunks past
# that); the select sorts at most _SELECT_MAX_K keys a query (csrc/knn.cu
# knn_select), and calls of larger K keep the seeded chained rounds.
_LIST_STEP = 256
_OVERFLOW_P = 1e-12
_LIST_BYTES = 2 * 1024**3
_SELECT_MAX_K = 4096

# The screen's skip (D = 3): candidates a segment, each with one bounding
# box (csrc/knn.cu kSegment).
_SEGMENT = 128

# K buckets of one round in which the auto gate (None) seeds single-round
# calls: none, as in the JAX package (tune_knn.py on an H100 80GB HBM3 at
# 700 W measured no gain worth the sample pass, PERF.md). Calls of K > 64
# are always seeded where a sample applies.
SEED_SINGLE_ROUND_BUCKETS: frozenset[int] = frozenset()


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


def _screen_queries(D: int) -> tuple[int, ...]:
    """Queries a thread the screen kernel may own: 1 or 2 where the queries
    live in registers (D <= 8), else 1."""
    return (1, 2) if D <= 8 else (1,)


def feasible_plans(N, P1, P2, D, K, resident: Callable[[Plan], int],
                   queries=None) -> list[Plan]:
    """Every plan the kernel takes for one round of min(K, 64) keys (or,
    with ``queries``, the screen kernel with those queries a thread) at
    these shapes, with at least one block resident on an SM."""
    if queries is None:
        queries = [q for q in (1, 2) if q <= _max_queries(K, D)]
    plans = [Plan(q, t, tile) for q in queries for t in _THREADS
             for tile in _tiles(P2, D)]
    return [p for p in plans if resident(p) >= 1]


def _launch_plan(N, P1, P2, D, K, sm_count: int,
                 resident: Callable[[Plan], int], queries=None) -> Plan:
    """The plan ``knn_topk_cuda`` launches: the default tile, Q = 1 where a
    larger Q would leave fewer blocks than SMs even at 32 threads, then the
    least ``_plan_cost``; on ties the larger block, then the smaller Q."""
    tile = _tiles(P2, D)[0]
    plans = [p for p in feasible_plans(N, P1, P2, D, K, resident, queries)
             if p.tile == tile]
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
_FLT_MIN = torch.finfo(torch.float32).tiny


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


def seed_of(ub: torch.Tensor) -> torch.Tensor:
    """The kernel's seed for an inclusive bound ``ub`` (float32): the next
    float up, so that a distance equal to ``ub`` is admitted, and at least
    the smallest normal float (knn_pallas.py's rule; a larger seed only
    admits more). +inf stays +inf: no seed."""
    return torch.clamp_min(torch.nextafter(ub, torch.full_like(ub, _INF)), _FLT_MIN)


def _seed_state(seed, K):
    """The state a seeded round starts from, (..., K) values and int64
    indices: (seed, SENT) where the seed is finite, else (inf, 0)."""
    finite = seed < _INF
    vals = seed[..., None].expand(*seed.shape, K)
    idx = torch.where(finite, SENT, 0)[..., None].expand(*seed.shape, K)
    return vals, idx


def _keep(d, pos, j, len2, lb):
    """Where a candidate may enter a round: its position below lengths2
    and, with ``lb`` = (values, indices) broadcastable against d, its
    (value, index) strictly above that lower bound."""
    keep = pos < len2
    if lb is not None:
        keep = keep & ((d > lb[0]) | ((d == lb[0]) & (j > lb[1])))
    return keep


def _knn_forward_full(p1, p2, lengths2, K, norm, ids=None, lb=None, seed=None):
    """Single-shot distance matrix and a stable sort (small problems).
    ``ids``: each p2 row's original index (int64), when p2 is reordered;
    ``lb``/``seed``: see ``_plain_round``."""
    P2 = p2.shape[1]
    d = pairwise_dist(p1, p2, norm)
    j = torch.arange(P2, device=p1.device)
    jj = j[None, None, :] if ids is None else ids[:, None, :]
    lbx = None if lb is None else (lb[0][..., None], lb[1][..., None])
    d = torch.where(_keep(d, j[None, None, :], jj, lengths2[:, None, None], lbx),
                    d, _INF)
    idx = jj.expand_as(d)
    if seed is not None:
        sd, si = _seed_state(seed, K)
        d, idx = torch.cat([sd, d], dim=-1), torch.cat([si, idx], dim=-1)
    vals, idx = _topk_rows(d, idx, min(K, d.shape[-1]), lex=ids is not None)
    if K > vals.shape[-1]:
        vals = torch.nn.functional.pad(vals, (0, K - vals.shape[-1]), value=_INF)
        idx = torch.nn.functional.pad(idx, (0, K - idx.shape[-1]))
    return vals, idx


def _knn_single_tiled(x, y, len2, K, norm, tile_p2, ids=None, lb=None, seed=None):
    """Streaming KNN for one cloud: scan tiles of y and merge a running
    top-K. Carried entries go first, so ties keep the earlier index (with
    ``ids``, y's original indices, ties are broken by those). ``lb``
    (values, indices) (C1,) and ``seed`` (C1,): see ``_plain_round``."""
    C1 = x.shape[0]
    if seed is None:
        cd = x.new_full((C1, K), _INF)
        ci = torch.zeros((C1, K), dtype=torch.int64, device=x.device)
    else:
        cd, ci = _seed_state(seed, K)
    lbx = None if lb is None else (lb[0][:, None], lb[1][:, None])
    for off in range(0, y.shape[0], tile_p2):
        yt = y[off : off + tile_p2]
        pos = torch.arange(off, off + yt.shape[0], device=x.device)
        j = pos if ids is None else ids[off : off + yt.shape[0]]
        d = pairwise_dist(x, yt, norm)
        d = torch.where(_keep(d, pos[None, :], j[None, :], len2, lbx), d, _INF)
        cd, ci = _topk_rows(
            torch.cat([cd, d], dim=1),
            torch.cat([ci, j.expand(C1, -1)], dim=1),
            K,
            lex=ids is not None,
        )
    return cd, ci


def _knn_forward_tiled(p1, p2, lengths2, K, norm, ids=None, lb=None, seed=None):
    """Tiled streaming forward for large problems: P1 in chunks, P2 in
    tiles, one cloud at a time."""
    N, P1, _ = p1.shape
    vals = p1.new_empty((N, P1, K))
    idx = torch.empty((N, P1, K), dtype=torch.int64, device=p1.device)
    for n in range(N):
        for a in range(0, P1, _TILE_P1):
            rows = slice(a, a + _TILE_P1)
            vals[n, rows], idx[n, rows] = _knn_single_tiled(
                p1[n, rows], p2[n], lengths2[n], K, norm, _TILE_P2,
                None if ids is None else ids[n],
                None if lb is None else (lb[0][n, rows], lb[1][n, rows]),
                None if seed is None else seed[n, rows],
            )
    return vals, idx


def _plain_round(p1, p2, lengths2, K, norm, ids=None, lb=None, seed=None):
    """One round of the kernel in plain PyTorch. ``lb`` = (values, int64
    indices), each (N, P1): a chained round's exclusive (value, index)
    lower bound. ``seed`` (N, P1): the state starts at K entries (seed,
    ``SENT``) where it is finite; these sort before candidates of equal
    value, and after them with ``ids`` (the kernel's carried rule: SENT is
    the largest index). An entry of value +inf takes index 0, as the
    kernel never admits one."""
    N, P1, _ = p1.shape
    if N * P1 * p2.shape[1] <= _FULL_MATRIX_MAX_ELEMS:
        vals, idx = _knn_forward_full(p1, p2, lengths2, K, norm, ids, lb, seed)
    else:
        vals, idx = _knn_forward_tiled(p1, p2, lengths2, K, norm, ids, lb, seed)
    return vals, torch.where(vals == _INF, 0, idx)


def knn_topk_plain(p1, p2, lengths2, K: int, norm: int, cand_ids=None, ub=None):
    """Plain PyTorch twin of the kernel, on any device: the full distance
    matrix for small problems, the tiled stream for large ones. With
    ``cand_ids`` (N, P2), p2 is reordered (its valid rows first) and
    ``cand_ids`` holds each row's original index: the indices returned are
    those, ties broken by them, as the kernel's carried instances do.
    ``ub`` (N, P1) float32: the raw seeded round of ``knn_topk(ub=)``,
    slots not filled below ``seed_of(ub)`` left at (that seed, ``SENT``)."""
    ids = None if cand_ids is None else cand_ids.to(torch.int64)
    return _plain_round(p1, p2, lengths2, K, norm, ids, None,
                        None if ub is None else seed_of(ub))


@functools.cache
def _lib():
    lib = _build.load("knn")
    lib.knn_topk.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.knn_resident_blocks.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.knn_screen.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p] * 4
    lib.knn_screen_resident.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.knn_select.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 4
    lib.knn_screen_order.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 4
    for fn in (lib.knn_topk, lib.knn_resident_blocks, lib.knn_screen,
               lib.knn_screen_resident, lib.knn_select, lib.knn_screen_order):
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


@functools.lru_cache(maxsize=None)
def _screen_resident(device: int, D: int, norm: int, plan: Plan) -> int:
    """Blocks of the screen kernel's instance for (D, norm, plan) that fit
    on one SM of CUDA device ``device``."""
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        _build.check(
            _lib().knn_screen_resident(D, norm, plan.queries, plan.threads,
                                       plan.tile, ctypes.byref(blocks)),
            "knn_screen_resident",
        )
    return blocks.value


@functools.lru_cache(maxsize=256)
def _screen_card_plan(device: int, N, P1, P2, D, norm) -> Plan:
    return _launch_plan(N, P1, P2, D, ROUND_K, _sm_count(device),
                        lambda plan: _screen_resident(device, D, norm, plan),
                        _screen_queries(D))


def screen_plans(p1, p2, norm: int, chunk: int | None = None
                 ) -> tuple[Plan, list[Plan]]:
    """(the plan the screen kernel launches, every feasible plan) for these
    CUDA inputs on their card, over chunks of ``chunk`` queries (default:
    all of them)."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    nq = P1 if chunk is None else min(chunk, P1)
    dev = p1.device.index
    return (_screen_card_plan(dev, N, nq, P2, D, norm),
            feasible_plans(N, nq, P2, D, ROUND_K,
                           lambda plan: _screen_resident(dev, D, norm, plan),
                           _screen_queries(D)))


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


def _default_sample_s(P2: int) -> int:
    """The sample size of the bounds (knn_pallas.py): about P2/16, a
    multiple of 1,024, within [4,096, 65,536]."""
    return min(max(P2 // 16 // 1024 * 1024, 4096), 65536)


def _rank_formula(mu, sqrt, ceil):
    """The sample rank whose distance bounds a quantile with ``mu``
    expected sample points below it: one expression for the Python ranks
    and the per-cloud tensor ranks, so the two never drift apart."""
    return ceil(mu + _BOUND_MARGIN_SIGMA * sqrt(mu) + _BOUND_MARGIN_ABS)


def _bound_m(mu: float) -> int:
    return int(_rank_formula(mu, math.sqrt, math.ceil))


def _rounds(K: int, P2: int) -> int:
    """Kernel rounds of one call: one for K <= 64, else ceil(min(K, P2) /
    64) chained 64-key rounds (later rounds cannot admit anything)."""
    return 1 if K <= ROUND_K else max(1, -(-min(K, P2) // ROUND_K))


def _quantiles(K: int, P2: int) -> list[int]:
    """Each round's closing quantile: the global rank its last slot holds."""
    if K <= ROUND_K:
        return [K]
    return [min((r + 1) * ROUND_K, K) for r in range(_rounds(K, P2))]


def _max_rank(kqs, P2: int, s: int) -> int:
    """The sample rank of the deepest quantile for a cloud of P2 // 2
    points, the shortest cloud whose bounds are used."""
    return _bound_m(s * kqs[-1] / max(P2 // 2, 1))


def seed_gate(K: int, P2: int, s: int, on_cuda: bool, sample_bound=None) -> bool:
    """Whether a call seeds its rounds from bounds on an ``s``-point sample.
    A sample applies for K > 1, ``P2 >= 4 * s`` and a deepest rank within
    ``min(s, 512)``. ``None`` takes the auto gate, off on CPU tensors: on
    for K > 64 and, for one round, in ``SEED_SINGLE_ROUND_BUCKETS``;
    ``True`` where no sample applies logs a warning and runs unseeded, as
    the JAX package does."""
    applies = (K > 1 and s >= 1 and P2 >= 4 * s
               and _max_rank(_quantiles(K, P2), P2, s) <= min(s, _MAX_RANK))
    if sample_bound is None:
        return (on_cuda and applies
                and (K > ROUND_K or _bucket(K) in SEED_SINGLE_ROUND_BUCKETS))
    if sample_bound and not applies:
        logger.warning(
            "sample_bound=True ignored: K=%d, P2=%d needs K > 1, P2 >= 4*s=%d and "
            "a deepest sample rank within min(s, %d): running unseeded",
            K, P2, 4 * s, _MAX_RANK)
        return False
    return bool(sample_bound)


def bound_ranks(lengths2, kqs, s: int, P2: int):
    """(m_max, m_r, usable) of ``kth_bounds``: the deepest rank for the
    shortest usable cloud (an int), each cloud's rank for each quantile
    ((N, R) int32, float32 arithmetic as in knn_pallas.py) and whether that
    bound is used ((N, R) bool: within m_max, cloud at least P2 // 2)."""
    l2f = torch.clamp_min(lengths2.to(torch.float32), 1.0)[:, None]
    # s * kq rounded in float32, as knn_pallas.py computes it.
    num = torch.stack([torch.full_like(l2f[:, 0], float(s)) * float(kq) for kq in kqs],
                      dim=1)
    m_r = _rank_formula(torch.div(num, l2f), torch.sqrt, torch.ceil).to(torch.int32)
    m_max = _max_rank(kqs, P2, s)
    usable = (m_r <= m_max) & (lengths2[:, None] >= max(P2 // 2, 1))
    return m_max, m_r, usable


def _poisson_below(lam: float, m: int) -> float:
    """P(X < m) for X ~ Poisson(lam), summed in log space."""
    if lam <= 0:
        return 1.0
    return sum(math.exp(i * math.log(lam) - lam - math.lgamma(i + 1)) for i in range(m))


@functools.lru_cache(maxsize=256)
def screen_cap(K: int, P2: int, s: int) -> int:
    """The entries of a query's list in the screen: the fewest, a multiple
    of ``_LIST_STEP``, at which a query of a full cloud overflows with
    probability at most ``_OVERFLOW_P``. Its bound is the m-th smallest of
    ``s`` sample distances, m the rank ``bound_ranks`` gives the call's last
    quantile at lengths2 = P2; its ``cap`` nearest candidates hold about
    Poisson(cap * s / P2) sample points, and fewer than m of them put the
    bound past the cap-th candidate. A shorter cloud is safer (lambda / m
    grows as lengths2 falls). An overflow only sends the query to the
    repair."""
    m = _bound_m(s * _quantiles(K, P2)[-1] / P2)
    cap = _LIST_STEP
    while _poisson_below(cap * s / P2, m) > _OVERFLOW_P:
        cap += _LIST_STEP
    return cap


def _screen_chunk(N: int, P1: int, cap: int) -> int:
    """Queries of each cloud a screen launch covers: all of them, or as
    many as keep the lists (N, chunk, cap) int64 within ``_LIST_BYTES``."""
    return max(1, min(P1, _LIST_BYTES // (8 * cap * max(N, 1))))


def _unseeded_topk(p1, p2, lengths2, K, norm, rows=None):
    """Top-K values and indices of the queries in the order ``rows`` (int64,
    or None: row order): the kernel on CUDA tensors, the plain twin on
    others."""
    if p1.is_cuda:
        N, P1, D = p1.shape
        plan = _card_plan(p1.device.index, N, P1, p2.shape[1], D, min(K, ROUND_K), norm)
        return _launch_rounds(p1, p2, lengths2, K, norm, plan,
                              None if rows is None else rows.to(torch.int32))
    return knn_topk_plain(p1 if rows is None else _gather_rows(p1, rows), p2,
                          lengths2, K, norm)


def kth_bounds(p1, p2, lengths2, kqs, norm: int, s: int, rows=None):
    """Per-query upper bounds on each quantile ``kqs[r]`` of the distances
    to the first ``lengths2`` points of p2 (``knn_pallas.py``
    ``_bigk_round_bounds``): one KNN of the queries (in the order ``rows``,
    if given) over s points taken at a stride from each cloud gives, for
    quantile r, the m_r-th smallest sample distance (``bound_ranks``). A
    list of (N, P1) float32, +inf where unused; None when the deepest rank
    exceeds ``min(s, 512)``. The bounds are the kernel's own distances, so
    a too-tight one is only ever a miss that the repair catches."""
    N, P1, _ = p1.shape
    P2 = p2.shape[1]
    m_max = _max_rank(kqs, P2, s)
    if m_max > min(s, _MAX_RANK):
        return None
    # The sample pass is launched first: the ranks' arithmetic below is
    # enqueued while it runs.
    stride = lengths2.to(torch.float32)[:, None] / float(s)
    pos = torch.arange(s, dtype=torch.float32, device=p2.device)[None, :] * stride
    sidx = torch.minimum(pos.to(torch.int64), torch.clamp_min(lengths2[:, None] - 1, 0))
    sample = _gather_rows(p2, sidx).contiguous()
    m_pad = -(-m_max // 8) * 8
    d_s, _ = _unseeded_topk(p1, sample, torch.clamp_max(lengths2, s), min(m_pad, s),
                            norm, rows)
    _, m_r, usable = bound_ranks(lengths2, kqs, s, P2)
    at = (torch.clamp(m_r, 1, m_max) - 1).to(torch.int64)
    taus = torch.gather(d_s, 2, at[:, None, :].expand(N, P1, len(kqs)))
    taus = torch.where(usable[:, None, :], taus, _INF)
    return [taus[..., r].contiguous() for r in range(len(kqs))]


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
    order = rows = None
    if sort_candidates or sort_queries:
        with tracing.span("knn.sort"):
            order = candidate_order(p1, p2, lengths2) if sort_candidates else None
            rows = _ss.morton_order(p1) if sort_queries else None
    return topk(p1, p2 if order is None else order.points, order, rows)


def _chain(launch, K, P2, seeds=None, gate=None, out=None):
    """The rounds of one call as per-round lists (values, indices): one
    round of K keys, or ``_rounds`` chained 64-key rounds, round r admitting
    only candidates above round r-1's last (value, index). ``launch(k, lb,
    seed, gate, out)`` runs one round; ``seeds``: one (N, P1) seed a round,
    or None; ``gate`` and ``out``: a repair rerun's (N, P1) int32 flags
    (the kernel's query order) and the per-round outputs it overwrites for
    the flagged queries."""
    rounds = _rounds(K, P2)
    k = K if K <= ROUND_K else ROUND_K
    ds, idxs, lb = [], [], None
    for r in range(rounds):
        d, i = launch(k, lb, None if seeds is None else seeds[r], gate,
                      None if out is None else (out[0][r], out[1][r]))
        ds.append(d)
        idxs.append(i)
        if r + 1 < rounds:
            lb = (d[..., -1].contiguous(), i[..., -1].contiguous())
    return ds, idxs


def _join(ds, idxs, K):
    """One call's (N, P1, K) values and indices from its rounds; slots past
    the last round are (inf, 0)."""
    if len(ds) == 1 and ds[0].shape[2] == K:
        return ds[0], idxs[0]
    d, i = torch.cat(ds, dim=2), torch.cat(idxs, dim=2)
    if d.shape[2] < K:
        d = torch.nn.functional.pad(d, (0, K - d.shape[2]), value=_INF)
        i = torch.nn.functional.pad(i, (0, K - i.shape[2]))
    return d[..., :K].contiguous(), i[..., :K].contiguous()


def repair_gate(idxs, lengths2, K):
    """One int32 on the rounds' device: 1 if a ``SENT`` is left in a slot
    k < min(K, lengths2) of any round (a bound was too tight), else 0.
    ``idxs``: the rounds' indices, round r holding slots 64r on (a joined
    output split into 64-slot pieces will do). A round's ``SENT`` slots are
    a suffix of each row (everything it admits sorts before its seed
    entries), so each round is read at its last slot below min(K,
    lengths2) alone. Computed on the device: no host sync."""
    last = torch.clamp_max(lengths2, K) - 1
    fails = []
    for r, i in enumerate(idxs):
        N, P1, k = i.shape
        at = last - r * ROUND_K
        slot = torch.clamp(at, 0, k - 1)[:, None, None].expand(N, P1, 1)
        fails.append(((torch.gather(i, 2, slot) == SENT)
                      & (at >= 0)[:, None, None]).any())
    return torch.stack(fails).any().to(torch.int32).reshape(1)


def _seeded(launch, K, P2, lengths2, seeds):
    """The seeded rounds and their repair (``knn_pallas.py``
    ``_repair_sentinels``): where ``repair_gate`` is 1 every round reruns
    unseeded into the same outputs (the word flags every query), which
    leaves the unseeded result; then every ``SENT`` slot left (past lengths2
    or past the last round's K) is set to (inf, 0), as unseeded."""
    with tracing.span("knn.rounds"):
        ds, idxs = _chain(launch, K, P2, seeds)
    with tracing.span("knn.repair"):
        gate = repair_gate(idxs, lengths2, K).expand(idxs[0].shape[:2]).contiguous()
        _chain(launch, K, P2, None, gate, (ds, idxs))
        d, i = _join(ds, idxs, K)
        sent = i == SENT
        return torch.where(sent, _INF, d), torch.where(sent, 0, i)


def _screened(screen, launch, K, P2, seed, cap):
    """A seeded call of more than one round by screen and select: every
    candidate below its query's seed is listed once and the K smallest by
    (value, index) are read off the list into the rounds' outputs
    (``screen(K, seed, cap, out)``, which returns the (N, P1) int32 flags);
    a query whose list may lack one of them (a count below min(K,
    lengths2) or above ``cap``, no finite seed) is flagged, and the chained
    unseeded rounds rerun for it into the same outputs (``_chain`` gated on
    the flags), which leaves the unseeded result. No host sync; no ``SENT``
    is ever written."""
    N, P1 = seed.shape
    shape = (_rounds(K, P2), N, P1, ROUND_K)
    out = (torch.empty(shape, dtype=torch.float32, device=seed.device),
           torch.empty(shape, dtype=torch.int64, device=seed.device))
    with tracing.span("knn.screen"):
        flags = screen(K, seed, cap, out)
    with tracing.span("knn.repair"):
        ds, idxs = list(out[0].unbind(0)), list(out[1].unbind(0))
        _chain(launch, K, P2, None, flags, (ds, idxs))
        return _join(ds, idxs, K)


def _screener(p1, p2, lengths2, norm, rows=None, cand_ids=None, plan=None,
              stats=None):
    """``screen(K, seed, cap, out)`` for ``_screened`` on CUDA tensors: the
    screen and select kernels of ``csrc/knn.cu`` over chunks of queries
    (``_screen_chunk``), under ``plan`` (default: ``_screen_card_plan``).
    ``rows`` and ``cand_ids`` (int32): as for ``_launcher``. Where
    ``_screen_skips``, the screen runs on ``screen_order_cuda``'s order of
    p2, built once a call, and skips the segments no query needs.
    ``stats``: a list to which each call appends {"cap", "counts", "flags",
    "scanned"} (the lists' whole lengths (N, P1) and the flags, kernel
    order; the share of (32 q queries, segment) pairs the screen scanned, a
    0-dim device tensor, None without the skip); it costs copies and a
    zeroed counter."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    dev = p1.device

    def ptr(t):
        return None if t is None else t.data_ptr()

    def screen(K, seed, cap, out):
        lib = _lib()
        stream = _build.stream_ptr(dev)
        chunk = _screen_chunk(N, P1, cap)
        q, threads, tile = plan or _screen_card_plan(dev.index, N, chunk, P2, D, norm)
        cands, ids, boxes = p2, cand_ids, None
        if _screen_skips(D):
            (cands, boxes), ids = screen_order_cuda(p2, lengths2, cand_ids), None
        flags = torch.empty((N, P1), dtype=torch.int32, device=dev)
        lists = torch.empty((N, chunk, cap), dtype=torch.int64, device=dev)
        counts = torch.empty((N, chunk), dtype=torch.int32, device=dev)
        segs = (torch.zeros((N, -(-chunk // (32 * q)), 2), dtype=torch.int64, device=dev)
                if stats is not None and boxes is not None else None)
        seen = []
        for q0 in range(0, P1, chunk):
            nq = min(chunk, P1 - q0)
            _build.check(
                lib.knn_screen(p1.data_ptr(), cands.data_ptr(), lengths2.data_ptr(),
                               ptr(rows), ptr(ids), seed.data_ptr(), ptr(boxes), N, P1,
                               P2, D, q0, nq, cap, norm, q, threads, tile,
                               lists.data_ptr(), counts.data_ptr(), ptr(segs), stream),
                "knn_screen",
            )
            tracing.launch("knn_screen_cuda")
            _build.check(
                lib.knn_select(lists.data_ptr(), counts.data_ptr(), lengths2.data_ptr(),
                               seed.data_ptr(), N, P1, P2, q0, nq, cap, K,
                               out[0].data_ptr(), out[1].data_ptr(), flags.data_ptr(),
                               stream),
                "knn_select",
            )
            tracing.launch("knn_select_cuda")
            if stats is not None:
                seen.append(counts.view(-1)[:N * nq].view(N, nq).clone())
        if stats is not None:
            scanned = None if segs is None else segs[..., 0].sum() / segs.sum()
            stats.append({"cap": cap, "counts": torch.cat(seen, dim=1),
                          "flags": flags.clone(), "scanned": scanned})
        return flags

    return screen


# A key no listed candidate takes: above every (float bits of d) << 32 | j.
_NO_KEY = 2**63 - 1


def screen_keys(d, j):
    """The screen's 64-bit keys (csrc/knn.cu): (float bits of d) << 32 | j,
    as int64, for d >= 0 (never -0) float32 and 0 <= j < 2**31; their order
    is (value, index) order."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | j


def _unkey(keys):
    """(values, indices) of screen keys; ``_NO_KEY`` gives (inf, 0)."""
    none = keys == _NO_KEY
    vals = (keys >> 32).to(torch.int32).view(torch.float32)
    return torch.where(none, _INF, vals), torch.where(none, 0, keys & 0xFFFFFFFF)


def _order_bits(P2: int) -> int:
    """Bits an axis of the screen order's cell codes: 2**(3 * bits) cells,
    between an eighth of P2 and P2, so that a segment of sorted candidates
    spans a few neighbouring cells; 1 to 10."""
    return min(10, max(1, -(-max(P2, 1).bit_length() // 3) - 1))


def _screen_skips(D: int) -> bool:
    """Whether the screen runs on its own order and skips segments: at D = 3
    (the D <= 8 and any-D instances keep the full scan). No other gate: the
    card measured the skip faster at every shape tried, lists of a ninth of
    the cloud with the queries unsorted included (PERF.md)."""
    return D == 3


def screen_order_plain(p2, lengths2, ids=None):
    """The screen's order of the candidates (D = 3) in plain PyTorch, the
    twin of ``screen_order_cuda``: each cloud's first ``lengths2`` rows
    sorted by cell code, ties in row order, the rows past them after, in
    place. The code: per axis the cell floor((p - lo) / (hi - lo) * 2**bits),
    ``bits = _order_bits(P2)``, clamped to the grid (0 where the box of the
    valid rows, NaN coordinates ignored, has no extent or the ratio is NaN),
    its bits interleaved x, y, z from the lowest. Returns (points (N, P2, 4)
    float32 in that order, each x, y, z and the bits of its original index,
    int32, or of ``ids[n, row]`` where given (``order_ids`` reads them);
    boxes (N, ceil(P2 / 128), 8) float32, each segment's lo (3), 0, hi (3),
    0 over its valid rows, NaN coordinates ignored, +inf / -inf where it has
    none)."""
    N, P2, _ = p2.shape
    dev = p2.device
    bits = _order_bits(P2)
    side = float(1 << bits)
    valid = torch.arange(P2, device=dev)[None, :] < lengths2.clamp(0, P2)[:, None]
    seen = valid[..., None] & ~torch.isnan(p2)
    lo = torch.where(seen, p2, _INF).amin(dim=1, keepdim=True)
    hi = torch.where(seen, p2, -_INF).amax(dim=1, keepdim=True)
    ext = hi - lo
    frac = torch.where(ext > 0, (p2 - lo) / ext, 0.0) * side
    cell = torch.fmin(torch.fmax(frac, frac.new_zeros(())),
                      frac.new_full((), side - 1)).to(torch.int64)
    code = torch.zeros((N, P2), dtype=torch.int64, device=dev)
    for b in range(bits):
        for a in range(3):
            code |= ((cell[..., a] >> b) & 1) << (3 * b + a)
    order = torch.sort(torch.where(valid, code, 1 << 31), dim=1, stable=True).indices
    points = torch.gather(p2, 1, order[..., None].expand(N, P2, 3))
    j = order if ids is None else torch.gather(ids.to(torch.int64), 1, order)
    nseg = -(-P2 // _SEGMENT)
    pad = (0, 0, 0, nseg * _SEGMENT - P2)
    live = torch.nn.functional.pad(valid[..., None] & ~torch.isnan(points), pad)
    live = live.view(N, nseg, _SEGMENT, 3)
    segs = torch.nn.functional.pad(points, pad).view(N, nseg, _SEGMENT, 3)
    slo = torch.where(live, segs, _INF).amin(dim=2)
    shi = torch.where(live, segs, -_INF).amax(dim=2)
    zero = slo.new_zeros((N, nseg, 1))
    j = j.to(torch.int32).view(torch.float32)[..., None]
    return torch.cat([points, j], dim=-1), torch.cat([slo, zero, shi, zero], dim=-1)


def order_ids(points):
    """The original indices (N, P2) int32 that the screen's order carries in
    its points' fourth float."""
    return points.view(torch.int32)[..., 3]


def screen_order_cuda(p2, lengths2, ids=None):
    """``screen_order_plain`` by ``csrc/knn.cu`` ``knn_screen_order_kernel``
    on CUDA tensors (D = 3; ``ids`` int32): one launch, a cluster of blocks
    a cloud. The points are a view of a buffer with ``_GROUP_SLOTS`` rows
    more, which the screen's prefetch may read past the last cloud."""
    N, P2, _ = p2.shape
    dev = p2.device
    points = torch.empty((N * P2 + _GROUP_SLOTS, 4), dtype=torch.float32, device=dev)
    boxes = torch.empty((N, -(-P2 // _SEGMENT), 8), dtype=torch.float32, device=dev)
    keys = torch.empty((2, N, P2), dtype=torch.int64, device=dev)
    _build.check(
        _lib().knn_screen_order(p2.data_ptr(), lengths2.data_ptr(),
                                None if ids is None else ids.data_ptr(), N, P2,
                                _order_bits(P2), keys.data_ptr(), points.data_ptr(),
                                boxes.data_ptr(), _build.stream_ptr(dev)),
        "knn_screen_order",
    )
    tracing.launch("knn_screen_order_cuda")
    return points[:N * P2].view(N, P2, 4), boxes


def segment_bound(q, lo, hi, norm: int):
    """The screen's bound on the distance from queries q (..., 3) to every
    point of the boxes [lo, hi] (..., 3), broadcast against each other
    (csrc/knn.cu ``box_distance``), in its order of operations: per axis the
    gap max(lo - q, q - hi, 0), NaN-ignoring as ``fmaxf`` is, squared at norm
    2, summed axis by axis as ``pairwise_dist`` sums. Each step rounds to
    nearest, which is monotone, so the bound is at most ``pairwise_dist`` of
    q and any point in the box; never NaN."""
    out = None
    for a in range(3):
        g = torch.fmax(lo[..., a] - q[..., a], q[..., a] - hi[..., a])
        g = torch.fmax(g, g.new_zeros(()))
        t = g * g if norm == 2 else g
        out = t if out is None else out + t
    return out


def _plain_screener(p1, p2, lengths2, norm, ids=None):
    """``screen`` for ``_screened`` on the plain twin, queries in their
    given order: the distances, ``d < seed``, each query's count and flag,
    and the K smallest kept candidates by their ``screen_keys`` (index:
    ``ids``, p2's original indices, where p2 is reordered) written to every
    row's slots; a flagged row's are then overwritten by the repair. Where
    ``_screen_skips``, on ``screen_order_plain``'s order, each candidate of
    a segment whose ``segment_bound`` is not below the query's seed left
    out (the kernel's skip, per query)."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    pos = torch.arange(P2, device=p1.device)
    len2 = lengths2.clamp(0, P2)

    def screen(K, seed, cap, out):
        cands, j, boxes = p2, (pos.expand(N, P2) if ids is None else ids), None
        if _screen_skips(D):
            cands, boxes = screen_order_plain(p2, lengths2, ids)
            cands, j = cands[..., :3], order_ids(cands).to(torch.int64)
        flags = torch.empty((N, P1), dtype=torch.int32, device=p1.device)
        step = max(1, _FULL_MATRIX_MAX_ELEMS // max(1, N * P2))
        for a in range(0, P1, step):
            rows = slice(a, a + step)
            d = pairwise_dist(p1[:, rows], cands, norm)
            sd = seed[:, rows]
            kept = (d < sd[..., None]) & (pos < len2[:, None, None])
            if boxes is not None:
                need = segment_bound(p1[:, rows, None], boxes[:, None, :, :3],
                                     boxes[:, None, :, 4:7], norm) < sd[..., None]
                kept = kept & need.repeat_interleave(_SEGMENT, dim=-1)[..., :P2]
            count = kept.sum(dim=-1)
            flags[:, rows] = (~(sd < _INF) | (count < len2.clamp(max=K)[:, None])
                              | (count > cap)).to(torch.int32)
            keys = torch.where(kept, screen_keys(d, j[:, None, :]), _NO_KEY)
            vals, idx = _unkey(torch.sort(keys, dim=-1).values[..., :min(K, P2)])
            if K > vals.shape[-1]:
                vals = torch.nn.functional.pad(vals, (0, K - vals.shape[-1]), value=_INF)
                idx = torch.nn.functional.pad(idx, (0, K - idx.shape[-1]))
            for r in range(out[0].shape[0]):
                lo, hi = r * ROUND_K, min((r + 1) * ROUND_K, K)
                out[0][r, :, rows, :hi - lo] = vals[..., lo:hi]
                out[1][r, :, rows, :hi - lo] = idx[..., lo:hi]
        return flags

    return screen


def _launcher(p1, p2, lengths2, norm, plan: Plan, rows=None, cand_ids=None,
              starts=None, counts=None):
    """``launch(k, lb, seed, gate, out)`` for ``_chain``: one launch of
    ``csrc/knn.cu``. ``rows`` (int32): the order the kernel takes the
    queries in, and its outputs' row order; ``cand_ids`` and ``starts``
    (int32): p2's original indices and each block's first tile."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    dev = p1.device
    fn = _lib().knn_topk
    stream = _build.stream_ptr(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch(k, lb, seed, gate, out):
        if out is None:
            out = (torch.empty((N, P1, k), dtype=torch.float32, device=dev),
                   torch.empty((N, P1, k), dtype=torch.int64, device=dev))
        lb_d, lb_i = (None, None) if lb is None else lb
        _build.check(
            fn(p1.data_ptr(), p2.data_ptr(), lengths2.data_ptr(), ptr(lb_d),
               ptr(lb_i), ptr(rows), ptr(cand_ids), ptr(starts), ptr(counts),
               ptr(seed), ptr(gate), N, P1, P2, D, k, norm, *plan,
               out[0].data_ptr(), out[1].data_ptr(), stream),
            "knn_topk",
        )
        tracing.launch("knn_topk_cuda")
        return out

    return launch


def _launch_rounds(p1, p2, lengths2, K, norm, plan: Plan, rows=None,
                   cand_ids=None, starts=None, counts=None, seeds=None):
    """The kernel's launches for one call, joined: one round, or ceil(K/64)
    chained 64-key rounds behind each query's (value, index) lower bound;
    ``seeds``: one (N, P1) seed a round (``seed_of``), in the kernel's
    query order, or None. See ``_launcher``."""
    launch = _launcher(p1, p2, lengths2, norm, plan, rows, cand_ids, starts, counts)
    return _join(*_chain(launch, K, p2.shape[1], seeds), K)


def _plain_launcher(p1, p2, lengths2, norm, ids=None):
    """``launch`` for ``_chain`` on the plain twin, queries in their given
    order; a gate's flags are read on the host (these are not CUDA tensors),
    and only the flagged queries' outputs are overwritten."""
    def launch(k, lb, seed, gate, out):
        if gate is not None:
            tracing.sync("knn.plain_gate")
            if not bool(gate.any()):
                return out
        d, i = _plain_round(p1, p2, lengths2, k, norm, ids, lb, seed)
        if out is None:
            return d, i
        if gate is not None:
            flagged = gate.bool()[..., None]
            d, i = torch.where(flagged, d, out[0]), torch.where(flagged, i, out[1])
        out[0].copy_(d)
        out[1].copy_(i)
        return out

    return launch


def _topk(p1, p2, lengths2, K, norm, make_launchers, sort_queries, sort_candidates,
          s=None, ub=None):
    """One call on either device: the sorts asked for, then the rounds of
    ``make_launchers(q, ref, order, rows)`` = (launch, screen), seeded from
    bounds on an ``s``-point sample if ``s`` is given (more than one round
    and K <= ``_SELECT_MAX_K``: screen and select at the last quantile's
    bound, then the repair of the flagged queries; else the seeded rounds
    and their repair), or from the inclusive bound ``ub`` (raw, one round),
    else unseeded."""
    P2 = p2.shape[1]

    def topk(q, ref, order, rows):
        launch, screen = make_launchers(q, ref, order, rows)
        if ub is not None:
            u = ub if rows is None else torch.gather(ub, 1, rows)
            with tracing.span("knn.rounds"):
                d, i = _join(*_chain(launch, K, P2, [seed_of(u)]), K)
        elif s is not None:
            kqs = _quantiles(K, P2)
            screened = len(kqs) > 1 and K <= _SELECT_MAX_K
            with tracing.span("knn.bounds"):
                taus = kth_bounds(q, ref, lengths2, kqs[-1:] if screened else kqs,
                                  norm, s, rows)
                seeds = [seed_of(t) for t in taus]
            if screened:
                d, i = _screened(screen, launch, K, P2, seeds[0], screen_cap(K, P2, s))
            else:
                d, i = _seeded(launch, K, P2, lengths2, seeds)
        else:
            with tracing.span("knn.rounds"):
                d, i = _join(*_chain(launch, K, P2), K)
        if rows is None:
            return d, i
        with tracing.span("knn.sort"):
            return _unpermute(d, rows), _unpermute(i, rows)

    return _with_sorting(p1, p2, lengths2, sort_queries, sort_candidates, topk)


def _check_ub(ub, p1, K, sample_bound):
    if ub is None:
        return
    if sample_bound:
        raise ValueError("knn_topk: give ub= or sample_bound=True, not both")
    if not 1 < K <= ROUND_K:
        raise ValueError(f"knn_topk: ub= seeds one round, 1 < K <= {ROUND_K} (K={K})")
    if (ub.shape != p1.shape[:2] or ub.dtype != torch.float32
            or ub.device != p1.device):
        raise ValueError("knn_topk: ub must be (N, P1) float32 on p1's device")


def knn_topk_cuda(p1, p2, lengths2, K: int, norm: int, *, sort_queries=None,
                  sort_candidates=None, sample_bound=None, sample_s=None, ub=None,
                  instrument: bool = False, _plan: Plan | None = None,
                  _stats: list | None = None):
    """Launch ``csrc/knn.cu`` on CUDA tensors: float32 points, int64
    lengths, all contiguous and on one device. K > 64 runs ceil(K/64)
    chained rounds. Returns (dists (N, P1, K) float32, idx (N, P1, K) int64),
    (inf, 0) in slots past ``lengths2``; with ``instrument``, also the
    (N, blocks, 5) int64 counters of ``COUNTERS`` per block of the launch
    (the blocks of the sorted queries, if sorted).

    ``sort_queries`` / ``sort_candidates``: Morton-sort the queries / the
    candidates (None: ``sort_gates``). Sorted candidates need the carried
    instances (D = 3, K >= 5; at norm 1 not 17 <= K <= 32), counters the counting ones (D = 3, norm 2,
    5 <= K <= 64): asked for elsewhere, they raise. ``sample_bound``:
    seed from bounds on a ``sample_s``-point sample (default
    ``_default_sample_s``; None: ``seed_gate``), with the repair, no host
    sync; not with ``instrument``. A seeded call of more than one round
    runs the screen and select kernels instead of seeded rounds
    (``_screened``). ``ub`` (N, P1) float32: seed one round
    (1 < K <= 64) at ``seed_of(ub)`` and return the raw state, ``SENT``
    slots included. ``_plan`` forces a
    launch plan (``tune_knn.py``); by default ``_launch_plan`` picks it.
    ``_stats``: see ``_screener`` (``chip_smoke.py``)."""
    _check_inputs(p1, p2, lengths2, K, norm)
    _check_ub(ub, p1, K, sample_bound)
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
    if instrument and sample_bound:
        raise ValueError("knn_topk_cuda: instrument=True counts one launch: give "
                         "ub= instead of sample_bound=True")
    dev = p1.device
    for t, dtype in ((p1, torch.float32), (p2, torch.float32),
                     (lengths2, torch.int64)):
        if not t.is_cuda or t.device != dev:
            raise ValueError("knn_topk_cuda needs every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"knn_topk_cuda needs contiguous {dtype} inputs")
    s = sample_s or _default_sample_s(P2)
    seeded = ub is None and not instrument and seed_gate(K, P2, s, True, sample_bound)
    plan = _plan or _card_plan(dev.index, N, P1, P2, D, min(K, ROUND_K), norm,
                               sort_candidates)
    block = plan.queries * plan.threads
    counts = (torch.zeros((N, -(-P1 // block), len(COUNTERS)), dtype=torch.int64,
                          device=dev) if instrument else None)

    def make_launchers(q, ref, order, rows):
        rows32 = None if rows is None else rows.to(torch.int32)
        ids = None if order is None else order.ids
        screen = _screener(q, ref, lengths2, norm, rows32, ids, stats=_stats)
        if order is None:
            return _launcher(q, ref, lengths2, norm, plan, rows32, counts=counts), screen
        return _launcher(q, ref, lengths2, norm, plan, rows32, order.ids,
                         scan_starts(q, order, block, plan.tile, rows), counts), screen

    d, i = _topk(p1, p2, lengths2, K, norm, make_launchers, sort_queries,
                 sort_candidates, s if seeded else None, ub)
    return (d, i, counts) if instrument else (d, i)


@tracing.spanned("knn_topk")
def knn_topk(p1, p2, lengths2, K: int, norm: int, *, sort_queries=None,
             sort_candidates=None, sample_bound=None, sample_s=None, ub=None):
    """The K nearest of the first ``lengths2[n]`` points of ``p2`` for every
    query in ``p1``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors, each with the Morton sorts and the seeding asked for
    (None: the auto gates, which are off on the CPU). See
    ``knn_topk_cuda``."""
    if p1.is_cuda:
        return knn_topk_cuda(p1, p2, lengths2, K, norm, sort_queries=sort_queries,
                             sort_candidates=sort_candidates,
                             sample_bound=sample_bound, sample_s=sample_s, ub=ub)
    if p1.device.type == "cpu":
        _check_inputs(p1, p2, lengths2, K, norm)
        _check_ub(ub, p1, K, sample_bound)
        N, P1, _ = p1.shape
        P2 = p2.shape[1]
        sq, sc = sort_gates(N * P1 * P2, K, False, sort_queries, sort_candidates)
        s = sample_s or _default_sample_s(P2)
        seeded = ub is None and seed_gate(K, P2, s, False, sample_bound)

        def make_launchers(q, ref, order, rows):
            q = q if rows is None else _gather_rows(q, rows)
            ids = None if order is None else order.ids.to(torch.int64)
            return (_plain_launcher(q, ref, lengths2, norm, ids),
                    _plain_screener(q, ref, lengths2, norm, ids))

        return _topk(p1, p2, lengths2, K, norm, make_launchers, sq, sc,
                     s if seeded else None, ub)
    raise ValueError(f"knn_topk: no kernel for device {p1.device}")
