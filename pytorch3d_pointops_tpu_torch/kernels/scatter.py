"""Deterministic row scatter-add: the Hopper kernels ``csrc/scatter.cu`` and
their plain PyTorch twins.

``out[n, idx[n, e], :] += contrib[n, e, :]`` over ``P2`` target rows, with
entries whose ``idx`` is negative skipped. Two entry points, one kernel
chain: ``scatter_add_rows`` (the KNN backward's grad_p2 and the gather
backward) and ``scatter_add_k1`` (the chamfer K=1 backward), replacing
``pytorch3d_pointops_tpu/kernels/scatter_pallas.py`` ``scatter_add_rows`` /
``scatter_add_rows_pallas`` and ``kernels/chamfer_pallas.py``
``scatter_add_k1_pallas``. Each runs where its inputs are: a CUDA tensor
launches the kernels, a CPU tensor takes ``scatter_add_plain``; any other
device raises.

The kernels partition the entries stably into buckets of consecutive rows
(one radix pass over the high bits of the flat key ``n * P2 + idx``), then
one block a bucket streams the bucket's entries in entry order into an
accumulator of its rows in shared memory: a memset and three launches, or
the bucket kernel alone where every row fits one bucket and the entries
are few. ``scatter_plan`` picks the buckets and passes from the shape. Each
row is summed in ascending entry order, so the sums are bit-equal to
``scatter_add_plain`` and from run to run; the design note is at the top
of ``csrc/scatter.cu``.

``bucket_order_plain`` models, in torch ops, the order in which the
kernels add the entries: the partition's radix passes, then each bucket's
chunks ordered by row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

_INT31 = 2**31 - 1
_MAX_DIGIT_BITS = 11  # csrc/scatter.cu kMaxWidth
_MAX_BUCKET_BITS = 11  # csrc/scatter.cu kMaxBucketBits: at most 2**11 rows a bucket
# The partition's buckets: 2**(bits - 8) rows, up to 2**10 (tune_scatter.py:
# a pass over digits wider than 8 bits, and buckets past 1,024 rows, cost
# more than they save at the main paths' shapes).
_PLAN_DIGIT_BITS = 8
_PLAN_BUCKET_BITS = 10
_REG_CHANNELS = 8  # csrc/scatter.cu kRegChannels: channels a bucket block sums
_CHUNK = 2048  # csrc/scatter.cu kChunk: entries a bucket block takes at once
# The bucket kernel alone takes every entry in one block, a chunk of 2,048
# at a time: past this many entries the partition is faster. A chunk costs
# about 0.0065 ms up to 1,792 rows (7 rows a thread in its scans) and
# 0.011 ms past them, the partition 0.023-0.046 ms in all (tune_scatter.py
# --direct-only), so the limit halves past 1,792 rows.
_DIRECT_MAX_ENTRIES = 1 << 13
_DIRECT_NARROW_ROWS = 1_792
_PLAIN_TILE = 256  # bucket_order_plain's tile; the permutation does not depend on it


def _check_inputs(idx, contrib, P2):
    if idx.dim() != 2 or contrib.dim() != 3 or idx.shape != contrib.shape[:2]:
        raise ValueError("idx must be (N, E) and contrib (N, E, C)")
    _check_P2(P2)


def _check_P2(P2):
    if not isinstance(P2, int) or P2 < 0:
        raise ValueError(f"P2 must be a non-negative int (got {P2!r})")


def check_limits(N: int, E: int, P2: int) -> None:
    """Raises ``ValueError`` when ``N * P2 + 1`` keys or ``N * E`` entries do
    not fit the kernels' 32-bit keys and entry ids (int31)."""
    if N * P2 + 1 > _INT31 or N * E > _INT31:
        raise ValueError(
            f"the scatter kernel takes N * P2 + 1 and N * E up to 2^31 - 1 "
            f"(got N={N}, E={E}, P2={P2})"
        )


class Plan(NamedTuple):
    """How ``csrc/scatter.cu`` cuts one scatter."""

    shift: int  # a bucket holds rows [b << shift, (b + 1) << shift)
    passes: int  # radix passes of the partition; 0: none, one bucket
    width: int  # bits of a partition digit
    channels: int  # channels a bucket block sums


def scatter_plan(N: int, E: int, P2: int, C: int) -> Plan:
    """The plan of the scatter of N x E entries into N * P2 rows of C
    channels. Every row in one bucket, no partition, where N * P2 is at most
    2**11 and N * E at most ``_DIRECT_MAX_ENTRIES`` (half that past
    ``_DIRECT_NARROW_ROWS`` rows); else buckets of
    2**shift rows, shift = bits(N * P2) - 8 clamped to [0, 10], so that one
    pass of 8-bit digits makes at most 2**8 buckets up to 2**18 rows, and as
    many passes of at most 11 bits as the bits above shift need. Channels go
    to blocks in the fewest groups of at most 8. Raises ``ValueError`` past
    the int31 limits of ``check_limits``."""
    check_limits(N, E, P2)
    rows = N * P2
    bits = max(1, rows.bit_length())
    groups = max(1, -(-C // _REG_CHANNELS))
    channels = max(1, -(-C // groups))
    direct_max = _DIRECT_MAX_ENTRIES >> (rows > _DIRECT_NARROW_ROWS)
    if rows <= 1 << _MAX_BUCKET_BITS and N * E <= direct_max:
        return Plan(bits, 0, 0, channels)
    shift = min(_PLAN_BUCKET_BITS, max(0, bits - _PLAN_DIGIT_BITS))
    passes = -(-(bits - shift) // _MAX_DIGIT_BITS)
    return Plan(shift, passes, -(-(bits - shift) // passes), channels)


def step_names(plan: Plan) -> tuple[str, ...]:
    """The steps of a scatter under ``plan``, in launch order: the steps
    ``_launch(..., events=)`` times, one event before the first and one
    after each."""
    if plan.passes == 0:
        return ("bucket sum",)
    return ("zero", "histogram", *(f"pass {p + 1}" for p in range(plan.passes)),
            "bucket sum")


def scatter_add_plain(idx, contrib, P2: int):
    """Plain PyTorch twin, on any device: ``index_add_`` into a flat
    (N * P2 + 1, C) buffer whose last row takes the skipped entries."""
    N, E, C = contrib.shape
    rows = idx + torch.arange(N, device=idx.device)[:, None] * P2
    rows = torch.where(idx >= 0, rows, N * P2).reshape(-1)
    out = contrib.new_zeros((N * P2 + 1, C))
    out.index_add_(0, rows, contrib.reshape(-1, C))
    return out[: N * P2].reshape(N, P2, C)


def _flat_keys(idx, P2):
    """The kernels' flat keys of idx (N, E) on the CPU: n * P2 + idx, and
    N * P2 for a skipped entry."""
    N = idx.shape[0]
    idx = idx.to(torch.int64).cpu()
    keys = torch.arange(N)[:, None] * P2 + idx
    return torch.where((idx >= 0) & (idx < P2), keys, N * P2).reshape(-1)


def _radix_passes(keys, vals, shift, passes, width):
    """The radix passes of ``csrc/scatter.cu`` in torch ops, over the key
    bits from ``shift`` up: each pass a stable counting sort over tiles of
    entries (digit-major tile counts, their exclusive scan, and each entry's
    rank among its tile's entries of the same digit)."""
    M = keys.numel()
    R, tile = 1 << width, _PLAIN_TILE
    tiles = -(-M // tile)
    tile_of = torch.arange(M) // tile
    for p in range(passes):
        digit = (keys >> (shift + p * width)) & (R - 1)
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
    return keys, vals


def bucket_order_plain(idx, P2: int, plan: Plan | None = None):
    """The order in which ``csrc/scatter.cu`` adds the entries under
    ``plan`` (default ``scatter_plan``'s), in torch ops on the CPU: the flat
    keys, the partition (the radix passes over the key bits from
    ``plan.shift`` up; none where ``plan.passes`` is 0), then each bucket's
    entries in chunks of ``_CHUNK``, each chunk stably ordered by key.
    Returns the flat keys and entry ids in that order, skipped entries (key
    N * P2) included."""
    _check_P2(P2)
    N, E = idx.shape
    plan = plan or scatter_plan(N, E, P2, 1)
    keys, vals = _flat_keys(idx, P2), torch.arange(N * E)
    if plan.passes:
        keys, vals = _radix_passes(keys, vals, plan.shift, plan.passes, plan.width)
    bucket = keys >> plan.shift
    # A chunk is named by its first position: the bucket's first position
    # plus whole chunks.
    first = torch.searchsorted(bucket, bucket)
    chunk = first + (torch.arange(N * E) - first) // _CHUNK * _CHUNK
    by_key = torch.argsort(keys, stable=True)
    order = by_key[torch.argsort(chunk[by_key], stable=True)]
    return keys[order], vals[order]


@functools.cache
def _lib():
    """The library with every entry point's types declared, once: declaring
    them costs microseconds of host time on each call."""
    lib = _build.load("scatter")
    lib.scatter_work_ints.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.scatter_work_ints.restype = ctypes.c_int64
    lib.scatter_add.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p] * 4
    lib.scatter_add.restype = ctypes.c_int
    return lib


def _event_array(events, count):
    """The raw handles of ``count`` recorded CUDA events, or None."""
    if events is None:
        return None
    if len(events) != count:
        raise ValueError(f"this launch records {count} events (got {len(events)})")
    return (ctypes.c_void_p * count)(*(e.cuda_event for e in events))


def _launch(idx, contrib, P2: int, events=None, plan: Plan | None = None):
    """The scatter on CUDA tensors, int64 idx and float32 contrib on one
    device: one call into ``csrc/scatter.cu`` that partitions the entries
    into buckets of rows and sums each bucket, under ``plan`` (default
    ``scatter_plan``'s; only tuning and checks force one). Raises
    ``ValueError`` on any other device, and past the int31 limits of
    ``check_limits`` on any device. ``events``, if given, is a sequence of
    ``len(step_names(plan)) + 1`` recorded
    ``torch.cuda.Event(enable_timing=True)``, for timing each step: one is
    recorded before the first step and one after each."""
    _check_inputs(idx, contrib, P2)
    N, E, C = contrib.shape
    plan = plan or scatter_plan(N, E, P2, C)
    if not idx.is_cuda or contrib.device != idx.device:
        raise ValueError("the scatter kernel needs idx and contrib on one CUDA device")
    if idx.dtype != torch.int64 or contrib.dtype != torch.float32:
        raise ValueError("the scatter kernel needs int64 idx and float32 contrib")
    lib = _lib()
    dev = idx.device
    idx, contrib = idx.contiguous(), contrib.contiguous()
    work = torch.empty(lib.scatter_work_ints(N * E, plan.passes, plan.width),
                       dtype=torch.int32, device=dev)
    out = torch.empty((N, P2, C), dtype=torch.float32, device=dev)
    _build.check(
        lib.scatter_add(idx.data_ptr(), contrib.data_ptr(), N, E, P2, C,
                        plan.shift, plan.passes, plan.width, plan.channels,
                        work.data_ptr(), out.data_ptr(),
                        _event_array(events, len(step_names(plan)) + 1),
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
    """The same scatter for the chamfer K=1 backward: idx (N, P1)
    int64, contrib (N, P1, C) -> (N, P2, C)."""
    return _dispatch(scatter_add_k1, idx, contrib, P2)


scatter_add_rows.launches = 0
scatter_add_k1.launches = 0
