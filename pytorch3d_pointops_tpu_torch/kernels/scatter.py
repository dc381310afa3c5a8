"""Deterministic row scatter-add: the Hopper kernels ``csrc/scatter.cu`` and
their plain PyTorch twins.

``out[n, idx[n, e], :] += contrib[n, e, :]`` over ``P2`` target rows, with
entries whose ``idx`` is negative skipped. Two entry points, one kernel
chain: ``scatter_add_rows`` (the KNN backward's grad_p2 and the gather
backward) and ``scatter_add_k1`` (the chamfer K=1 backward), replacing
``pytorch3d_pointops_tpu/kernels/scatter_pallas.py`` ``scatter_add_rows`` /
``scatter_add_rows_pallas`` and ``kernels/chamfer_pallas.py``
``scatter_add_k1_pallas``. Each runs where its inputs are: a CUDA tensor
launches the kernels (a radix sort of the entries by target row, then a
segment sum), a CPU tensor takes ``scatter_add_plain``; any other device
raises. The kernel's sums are bit-equal from run to run; the design note is
at the top of ``csrc/scatter.cu``.

``sort_plan`` exposes the sort alone (its plain twin is ``segment_plan``),
and ``radix_plan_plain`` models its digits and passes in torch ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_INT31 = 2**31 - 1
_MAX_DIGIT_BITS = 11  # csrc/scatter.cu kMaxWidth
_PLAIN_TILE = 256  # radix_plan_plain's tile; the permutation does not depend on it


def _check_inputs(idx, contrib, P2):
    if idx.dim() != 2 or contrib.dim() != 3 or idx.shape != contrib.shape[:2]:
        raise ValueError("idx must be (N, E) and contrib (N, E, C)")
    _check_P2(P2)


def _check_P2(P2):
    if not isinstance(P2, int) or P2 < 0:
        raise ValueError(f"P2 must be a non-negative int (got {P2!r})")


def radix_digits(N: int, E: int, P2: int) -> tuple[int, int]:
    """(passes, width) of the radix sort over the flat keys 0..N*P2: the
    fewest passes of at most 11-bit digits that cover ``N * P2``, with the
    bits split evenly. Raises ``ValueError`` when ``N * P2 + 1`` buckets or
    ``N * E`` entries do not fit in int31."""
    if N * P2 + 1 > _INT31 or N * E > _INT31:
        raise ValueError(
            f"the scatter kernel takes N * P2 + 1 and N * E up to 2^31 - 1 "
            f"(got N={N}, E={E}, P2={P2})"
        )
    bits = max(1, (N * P2).bit_length())
    passes = -(-bits // _MAX_DIGIT_BITS)
    return passes, -(-bits // passes)


def scatter_add_plain(idx, contrib, P2: int):
    """Plain PyTorch twin, on any device: ``index_add_`` into a flat
    (N * P2 + 1, C) buffer whose last row takes the skipped entries."""
    N, E, C = contrib.shape
    rows = idx + torch.arange(N, device=idx.device)[:, None] * P2
    rows = torch.where(idx >= 0, rows, N * P2).reshape(-1)
    out = contrib.new_zeros((N * P2 + 1, C))
    out.index_add_(0, rows, contrib.reshape(-1, C))
    return out[: N * P2].reshape(N, P2, C)


def segment_plan(idx, P2: int):
    """The order the segment sum takes: each row's entries sorted by target
    (skipped entries keyed ``P2``, after every real target), stably, so equal
    targets keep ascending entry order. Returns (sorted_keys, order), both
    (N, E) int64. The plain twin of ``sort_plan``."""
    keys = torch.where(idx >= 0, idx, P2)
    order = torch.argsort(keys, dim=1, stable=True)
    return torch.gather(keys, 1, order), order


def _flat_plan_to_rows(keys, vals, N, E, P2):
    """Sorted flat keys and entry ids in ``segment_plan``'s per-row layout,
    as ``plan_layout_kernel`` in ``csrc/scatter.cu`` places them."""
    skip = N * P2
    p = torch.arange(keys.numel())
    valid = keys < skip
    n = torch.where(valid, keys // max(P2, 1), vals // max(E, 1))
    first = torch.searchsorted(keys, n * P2)
    after = torch.searchsorted(keys, (n + 1) * P2)
    first_skipped = torch.searchsorted(keys, torch.tensor([skip]))
    dst = torch.where(valid, n * E + p - first, after + p - first_skipped)
    sorted_keys = torch.empty(N * E, dtype=torch.int64)
    order = torch.empty(N * E, dtype=torch.int64)
    sorted_keys[dst] = torch.where(valid, keys - n * P2, P2)
    order[dst] = vals - n * E
    return sorted_keys.reshape(N, E), order.reshape(N, E)


def radix_plan_plain(idx, P2: int):
    """The kernel's sort in torch ops, on the CPU: the same flat keys, digit
    widths and pass count, each pass a stable counting sort over tiles of
    entries (digit-major tile counts, their exclusive scan, and each entry's
    rank among its tile's entries of the same digit). Returns
    ``segment_plan``'s (sorted_keys, order) for idx within [-1, P2)."""
    _check_P2(P2)
    N, E = idx.shape
    passes, width = radix_digits(N, E, P2)
    idx = idx.to(torch.int64).cpu()
    M = N * E
    keys = torch.arange(N)[:, None] * P2 + idx
    keys = torch.where((idx >= 0) & (idx < P2), keys, N * P2).reshape(-1)
    vals = torch.arange(M)
    R, tile = 1 << width, _PLAIN_TILE
    tiles = -(-M // tile)
    tile_of = torch.arange(M) // tile
    for p in range(passes):
        digit = (keys >> (p * width)) & (R - 1)
        counts = torch.bincount(digit * tiles + tile_of, minlength=R * tiles)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.empty(M, dtype=torch.int64)
        for t in range(tiles):
            d = digit[t * tile:(t + 1) * tile]
            onehot = torch.nn.functional.one_hot(d, R)
            rank[t * tile:(t + 1) * tile] = (
                (torch.cumsum(onehot, 0) - onehot).gather(1, d[:, None])[:, 0]
            )
        slot = start[digit * tiles + tile_of] + rank
        new_keys, new_vals = torch.empty_like(keys), torch.empty_like(vals)
        new_keys[slot], new_vals[slot] = keys, vals
        keys, vals = new_keys, new_vals
    return _flat_plan_to_rows(keys, vals, N, E, P2)


@functools.cache
def _lib():
    """The library with every entry point's types declared, once: declaring
    them costs microseconds of host time on each call."""
    lib = _build.load("scatter")
    lib.scatter_work_ints.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.scatter_work_ints.restype = ctypes.c_int64
    lib.scatter_add.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 4
    lib.scatter_sort_plan.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 4
    for fn in (lib.scatter_add, lib.scatter_sort_plan):
        fn.restype = ctypes.c_int
    return lib


def _event_array(events, count):
    """The raw handles of ``count`` recorded CUDA events, or None."""
    if events is None:
        return None
    if len(events) != count:
        raise ValueError(f"this launch records {count} events (got {len(events)})")
    return (ctypes.c_void_p * count)(*(e.cuda_event for e in events))


def _launch(idx, contrib, P2: int, events=None):
    """The scatter on CUDA tensors, int64 idx and float32 contrib on one
    device: one call into ``csrc/scatter.cu`` that sorts the entries and
    sums the segments. Raises ``ValueError`` on any other device, and past
    the int31 limits of ``radix_digits`` on any device. ``events``, if
    given, is a sequence of ``passes + 4`` recorded
    ``torch.cuda.Event(enable_timing=True)``, for timing each step: one is
    recorded before the first step, one after the zeroing of the sort's
    counters, the histogram, each radix pass and the segment sum."""
    _check_inputs(idx, contrib, P2)
    N, E, C = contrib.shape
    passes, width = radix_digits(N, E, P2)
    if not idx.is_cuda or contrib.device != idx.device:
        raise ValueError("the scatter kernel needs idx and contrib on one CUDA device")
    if idx.dtype != torch.int64 or contrib.dtype != torch.float32:
        raise ValueError("the scatter kernel needs int64 idx and float32 contrib")
    lib = _lib()
    dev = idx.device
    idx, contrib = idx.contiguous(), contrib.contiguous()
    work = torch.empty(lib.scatter_work_ints(N * E, passes, width),
                       dtype=torch.int32, device=dev)
    out = torch.empty((N, P2, C), dtype=torch.float32, device=dev)
    _build.check(
        lib.scatter_add(idx.data_ptr(), contrib.data_ptr(), N, E, P2, C, passes,
                        width, work.data_ptr(), out.data_ptr(),
                        _event_array(events, passes + 4),
                        _build.stream_ptr(dev)),
        "scatter_add",
    )
    return out


def _dispatch(wrapper, idx, contrib, P2):
    if idx.device.type == "cpu":
        _check_inputs(idx, contrib, P2)
        return scatter_add_plain(idx, contrib, P2)
    out = _launch(idx, contrib, P2)
    wrapper.launches += 1
    return out


def scatter_add_rows(idx, contrib, P2: int):
    """Deterministic ``out[n, idx[n, e]] += contrib[n, e]`` for the KNN
    backward: idx (N, E) int64, contrib (N, E, C) -> (N, P2, C)."""
    return _dispatch(scatter_add_rows, idx, contrib, P2)


def scatter_add_k1(idx, contrib, P2: int):
    """The same segment-sum for the chamfer K=1 backward: idx (N, P1)
    int64, contrib (N, P1, C) -> (N, P2, C)."""
    return _dispatch(scatter_add_k1, idx, contrib, P2)


def sort_plan(idx, P2: int):
    """The scatter's sort alone, in ``segment_plan``'s layout: idx (N, E)
    int64 -> (sorted_keys, order), both (N, E) int64. CUDA tensors launch
    the radix sort of ``csrc/scatter.cu``; CPU tensors take
    ``segment_plan``; other devices raise."""
    if idx.dim() != 2:
        raise ValueError("idx must be (N, E)")
    _check_P2(P2)
    if idx.device.type == "cpu":
        return segment_plan(idx, P2)
    N, E = idx.shape
    passes, width = radix_digits(N, E, P2)
    if not idx.is_cuda or idx.dtype != torch.int64:
        raise ValueError(f"sort_plan: no kernel for {idx.dtype} idx on {idx.device}")
    lib = _lib()
    dev = idx.device
    idx = idx.contiguous()
    work = torch.empty(lib.scatter_work_ints(N * E, passes, width),
                       dtype=torch.int32, device=dev)
    sorted_keys = torch.empty((N, E), dtype=torch.int64, device=dev)
    order = torch.empty((N, E), dtype=torch.int64, device=dev)
    _build.check(
        lib.scatter_sort_plan(idx.data_ptr(), N, E, P2, passes, width,
                              work.data_ptr(), sorted_keys.data_ptr(),
                              order.data_ptr(), _build.stream_ptr(dev)),
        "scatter_sort_plan",
    )
    sort_plan.launches += 1
    return sorted_keys, order


scatter_add_rows.launches = 0
scatter_add_k1.launches = 0
sort_plan.launches = 0
