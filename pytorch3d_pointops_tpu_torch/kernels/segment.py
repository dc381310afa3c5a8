"""Segment reductions over sorted clusters of rows and the voxel keys that
make them: the Hopper kernels ``csrc/segment.cu`` and their plain PyTorch
twins, for the grid pooling of ``ops/grid_pool.py``.

A segment is a run of consecutive positions ``s`` in ``[offsets[m],
offsets[m + 1])`` of a stable order of rows, ``order`` (int64); the row at
position ``s`` is ``order[s]``. Each wrapper runs where its inputs are: a
CUDA tensor launches its kernel and counts the launch in ``tracing``'s
``launch.<wrapper>`` counter, a CPU tensor takes the twin; any other device
raises. Every sum is a fold in sorted order from 0, each add rounded on its
own, and every other result is exact, so kernel and twin are bit-equal; the
design note is at the top of ``csrc/segment.cu``. These kernels replace no
TPU kernel: the JAX package has no grid pooling.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, tracing

AXIS_BITS = 17  # csrc/segment.cu kAxisBits: a key's bits a voxel axis
MAX_CLOUDS = 1 << (63 - 3 * AXIS_BITS)  # the key's cloud bits


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@functools.cache
def _lib():
    lib = _build.load("segment")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for name, args in (("segment_keys", [p, p, i, i64, p, f, p, p, p]),
                       ("segment_bounds", [p, p, i64, p, i, p, p, p, p]),
                       ("segment_sum", [p, p, p, i64, i, i, p, p]),
                       ("segment_max", [p, p, p, i64, i, p, p, p]),
                       ("segment_max_backward", [p, p, p, i64, i, p, p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _cuda(name: str, *tensors) -> bool:
    """True where the inputs lie on one CUDA device, False on the CPU;
    raises on any other device or a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: the inputs lie on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {dev.type}")
    return dev.type == "cuda"


def _float32(name: str, *tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: the kernel takes float32 values "
                         f"(got {[str(t.dtype) for t in tensors]})")


def _launch(name: str, dev, *args) -> None:
    _build.check(getattr(_lib(), name)(*args, _build.stream_ptr(dev)), name)
    tracing.launch(name)


# --- plain twins ---------------------------------------------------------


def segment_keys_plain(pos, first, start, grid: float):
    """(keys (T,) int64, flag): each row's voxel key, the cloud above the
    z, y and x voxels of 17 bits each, and 1 where a quotient lies outside
    [0, 2^17) or is NaN, else 0."""
    T = pos.shape[0]
    cloud = torch.searchsorted(first, torch.arange(T), right=True) - 1
    q = (pos - start[cloud]) / torch.full((1,), grid, dtype=torch.float32)
    bad = ~((q >= 0) & (q < float(1 << AXIS_BITS)))
    v = q.to(torch.int64) & ((1 << AXIS_BITS) - 1)
    keys = cloud
    for d in (2, 1, 0):
        keys = (keys << AXIS_BITS) | v[:, d]
    return keys, int(bad.any())


def segment_bounds_plain(ids, order, ends, offsets_size: int):
    """(offsets (offsets_size,), cluster (T,), counts (N,)) from the
    heads' inclusive scan ``ids`` and the stable ``order``; the entries of
    offsets past M + 1 are left 0."""
    T = ids.numel()
    offsets = torch.zeros(offsets_size, dtype=torch.int64)
    cluster = torch.empty(T, dtype=torch.int64)
    if T:
        id_ = ids - 1
        head = torch.ones(T, dtype=torch.bool)
        head[1:] = ids[1:] != ids[:-1]
        offsets[id_[head]] = torch.arange(T)[head]
        offsets[int(id_[-1]) + 1] = T
        cluster[order] = id_
    counts = torch.where(ends > 0, ids[(ends - 1).clamp(min=0)] if T else 0, 0)
    return offsets, cluster, counts


def _fold(x, order, offsets, step):
    """Every segment's fold over its positions in order, all segments at
    once: for j from 0 to the longest segment's length, ``acc = step(acc,
    values, rows, valid)`` with the (M, C) values and (M,) rows at position
    j of each segment, and ``valid`` (M, 1) where a segment reaches j (acc
    is None at j = 0)."""
    starts, lengths = offsets[:-1], offsets.diff()
    longest = int(lengths.max()) if lengths.numel() else 0
    acc = None
    for j in range(longest):
        pos = order[(starts + j).clamp(max=order.numel() - 1)]
        acc = step(acc, x[pos], pos, (j < lengths)[:, None])
    return acc


def segment_sum_plain(x, order, offsets, mean: bool = False):
    M, C = offsets.numel() - 1, x.shape[1]
    if M == 0:
        return x.new_zeros((0, C))

    def add(acc, v, _row, valid):
        acc = x.new_zeros((M, C)) if acc is None else acc
        return torch.where(valid, acc + v, acc)

    out = _fold(x, order, offsets, add)
    return out / offsets.diff()[:, None].to(x.dtype) if mean else out


def segment_max_plain(x, order, offsets):
    M, C = offsets.numel() - 1, x.shape[1]
    if M == 0:
        return x.new_zeros((0, C)), torch.zeros((0, C), dtype=torch.int32)

    def take(acc, v, row, valid):
        row = row[:, None].expand(M, C)
        if acc is None:
            return v, row
        best, arg = acc
        better = valid & (v > best)
        return torch.where(better, v, best), torch.where(better, row, arg)

    best, arg = _fold(x, order, offsets, take)
    return best, arg.to(torch.int32)


def segment_max_backward_plain(grad_out, arg, cluster):
    T, C = cluster.numel(), grad_out.shape[1]
    rows = torch.arange(T)[:, None]
    return torch.where(arg[cluster].to(torch.int64) == rows, grad_out[cluster],
                       grad_out.new_zeros(()))


# --- wrappers ----------------------------------------------------------------


def segment_keys(pos, first, start, grid: float, flag):
    """(T,) int64 voxel keys of rows pos (T, 3) float32 of the clouds whose
    first rows are first (N,) int64, at cell size ``grid`` (float32) from
    each cloud's start (N, 3); ``flag`` (a one-element int64 tensor, 0 on
    entry) becomes nonzero where a quotient falls outside [0, 2^17) or is
    NaN. At most ``MAX_CLOUDS`` clouds."""
    if first.numel() > MAX_CLOUDS:
        raise ValueError(f"grid pooling takes at most {MAX_CLOUDS} clouds (got {first.numel()})")
    if not _cuda("segment_keys", pos, first, start, flag):
        keys, bad = segment_keys_plain(pos, first, start, grid)
        flag |= bad
        return keys
    _float32("segment_keys", pos, start)
    pos, start = pos.contiguous(), start.contiguous()
    keys = torch.empty(pos.shape[0], dtype=torch.int64, device=pos.device)
    _launch("segment_keys", pos.device, _ptr(pos), _ptr(first), first.numel(), pos.shape[0],
            _ptr(start), grid, _ptr(keys), _ptr(flag))
    return keys


def segment_bounds(ids, order, ends, offsets_size: int, counts):
    """From ``ids`` (T,) int64, the heads' inclusive scan, and the stable
    ``order`` (T,): (offsets (offsets_size,) with each cluster's first
    sorted position and T after the last, the rest unset; cluster (T,),
    each row's cluster). ``counts`` (N,) int64 receives each cloud's
    clusters up to its end, ``ends`` (N,) int64 its rows' end."""
    if not _cuda("segment_bounds", ids, order, ends, counts):
        offsets, cluster, got = segment_bounds_plain(ids, order, ends, offsets_size)
        counts.copy_(got)
        return offsets, cluster
    dev = ids.device
    offsets = torch.empty(offsets_size, dtype=torch.int64, device=dev)
    cluster = torch.empty_like(order)
    _launch("segment_bounds", dev, _ptr(ids), _ptr(order), ids.numel(), _ptr(ends),
            ends.numel(), _ptr(offsets), _ptr(cluster), _ptr(counts))
    return offsets, cluster


def segment_sum(x, order, offsets, mean: bool = False):
    """(M, C) float32: each segment's sum of ``x[order[s]]`` (x (rows, C)
    float32) in sorted order from 0, over its count where ``mean``."""
    if not _cuda("segment_sum", x, order, offsets):
        return segment_sum_plain(x, order, offsets, mean)
    _float32("segment_sum", x)
    x, M = x.contiguous(), offsets.numel() - 1
    out = torch.empty((M, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch("segment_sum", x.device, _ptr(x), _ptr(order), _ptr(offsets), M, x.shape[1],
            int(mean), _ptr(out))
    return out


def segment_max(x, order, offsets):
    """((M, C) float32, (M, C) int32): each segment's largest ``x[order[s]]``
    in sorted order, the first of equal maxima, and its row. Segments are
    not empty."""
    if not _cuda("segment_max", x, order, offsets):
        return segment_max_plain(x, order, offsets)
    _float32("segment_max", x)
    x, M = x.contiguous(), offsets.numel() - 1
    out = torch.empty((M, x.shape[1]), dtype=torch.float32, device=x.device)
    arg = torch.empty((M, x.shape[1]), dtype=torch.int32, device=x.device)
    _launch("segment_max", x.device, _ptr(x), _ptr(order), _ptr(offsets), M, x.shape[1],
            _ptr(out), _ptr(arg))
    return out, arg


def segment_max_backward(grad_out, arg, cluster):
    """(T, C) float32: ``grad_out[cluster[r], c]`` where row r holds that
    segment's maximum (``arg``), else 0."""
    if not _cuda("segment_max_backward", grad_out, arg, cluster):
        return segment_max_backward_plain(grad_out, arg, cluster)
    _float32("segment_max_backward", grad_out)
    grad_out = grad_out.contiguous()
    T, C = cluster.numel(), grad_out.shape[1]
    grad_x = torch.empty((T, C), dtype=torch.float32, device=grad_out.device)
    _launch("segment_max_backward", grad_out.device, _ptr(grad_out), _ptr(arg), _ptr(cluster),
            T, C, _ptr(grad_x))
    return grad_x
