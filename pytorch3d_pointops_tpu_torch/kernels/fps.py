"""Iterative farthest point sampling: the Hopper kernels ``csrc/fps.cu`` and
their plain PyTorch twin.

Three entry points, one per TPU kernel of
``pytorch3d_pointops_tpu/kernels/fps_pallas.py``:

* ``fps_batched`` (``fps_pallas_batched``): one block per cloud, the cloud
  held in shared memory; for clouds up to ``fps_limits(...)[0]`` points;
* ``fps_resident`` (``fps_pallas``): every SM on one cloud at a time, the
  cloud held in shared memory across the SMs; up to ``fps_limits(...)[1]``;
* ``fps_streaming`` (``fps_pallas_chunked``): every SM on one cloud, points
  and min-distances streamed from device memory every round; any size, any D.

Each takes points (N, P, D) float32 and lengths, K, start indices (N,)
int64, and returns idx (N, max_K) int64: ``idx[n, 0]`` is the start, each
later slot the point farthest from those selected so far (on ties the
lowest index), -1 past ``min(K[n], lengths[n])``. Each runs where its
inputs are: CUDA tensors launch its kernel, CPU tensors take ``fps_plain``;
any other device raises. ``ops.fps`` picks the entry point by size. The
design note is at the top of ``csrc/fps.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_INF = float("inf")


def fps_plain(points, lengths, K, starts, max_K: int):
    """Plain PyTorch twin of the kernels, on any device: all clouds advance
    through each round together, distances summed axis by axis in order."""
    N, P, D = points.shape
    dev = points.device
    out = torch.full((N, max_K), -1, dtype=torch.int64, device=dev)
    if max_K == 0:
        return out
    valid = torch.arange(P, device=dev)[None, :] < lengths[:, None]
    k_n = torch.minimum(lengths, K)
    idx0 = torch.where(k_n > 0, starts, -1)
    out[:, 0] = idx0
    # Padded points sit at -1 and never win against a valid point (>= 0).
    min_d = torch.where(valid, _INF, -1.0).to(torch.float32)
    last = idx0.clamp(min=0)
    rows = torch.arange(N, device=dev)
    for i in range(1, max_K):
        sel = points[rows, last]  # (N, D)
        d2 = points.new_zeros((N, P))
        for d in range(D):
            diff = points[:, :, d] - sel[:, None, d]
            d2 = d2 + diff * diff
        min_d = torch.minimum(min_d, torch.where(valid, d2, -1.0))
        nxt = torch.argmax(min_d, dim=1)  # the first maximum
        active = i < k_n
        out[:, i] = torch.where(active, nxt, -1)
        last = torch.where(active, nxt, last)
    return out


def _check_inputs(points, lengths, K, starts, max_K):
    if points.dim() != 3:
        raise ValueError("points must be (N, P, D)")
    N = points.shape[0]
    for name, t in (("lengths", lengths), ("K", K), ("start_idxs", starts)):
        if t.shape != (N,):
            raise ValueError(f"{name} must be of shape (N,)")
    if not isinstance(max_K, int) or max_K < 0:
        raise ValueError(f"max_K must be a non-negative int (got {max_K!r})")


def _lib():
    lib = _build.load("fps")
    lib.fps_limits.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.fps_grid_max_blocks.argtypes = []
    lib.fps_block.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fps_grid.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    for fn in (lib.fps_limits, lib.fps_grid_max_blocks, lib.fps_block, lib.fps_grid):
        fn.restype = ctypes.c_int
    return lib


def fps_limits(D: int, device) -> tuple[int, int]:
    """(block, resident): the largest cloud ``fps_batched`` and
    ``fps_resident`` take at dimension D on this CUDA device, set by its
    shared memory per block and its number of SMs."""
    block = ctypes.c_int64()
    resident = ctypes.c_int64()
    with torch.cuda.device(device):
        _build.check(
            _lib().fps_limits(D, ctypes.byref(block), ctypes.byref(resident)),
            "fps_limits",
        )
    return block.value, resident.value


def _launch(mode, points, lengths, K, starts, max_K):
    """Launch ``csrc/fps.cu`` on CUDA tensors: float32 points, int64
    lengths/K/starts, all contiguous and on one device."""
    _check_inputs(points, lengths, K, starts, max_K)
    for t, dtype in ((points, torch.float32), (lengths, torch.int64),
                     (K, torch.int64), (starts, torch.int64)):
        if not t.is_cuda or t.device != points.device:
            raise ValueError("the FPS kernels need every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"the FPS kernels need contiguous {dtype} inputs")
    N, P, D = points.shape
    dev = points.device
    out = torch.empty((N, max_K), dtype=torch.int64, device=dev)
    lib = _lib()
    args = (points.data_ptr(), lengths.data_ptr(), K.data_ptr(), starts.data_ptr(),
            N, P, D, max_K)
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        if mode == "block":
            err = lib.fps_block(*args, out.data_ptr(), stream)
        else:
            resident = mode == "resident"
            partials = torch.empty(2 * lib.fps_grid_max_blocks(),
                                   dtype=torch.int64, device=dev)
            min_d = None if resident else torch.empty(P, dtype=torch.float32,
                                                      device=dev)
            err = lib.fps_grid(*args, int(resident),
                               None if min_d is None else min_d.data_ptr(),
                               partials.data_ptr(), out.data_ptr(), stream)
    _build.check(err, f"fps ({mode})")
    return out


def _dispatch(wrapper, mode, points, lengths, K, starts, max_K):
    if points.is_cuda:
        out = _launch(mode, points, lengths, K, starts, max_K)
        wrapper.launches += 1
        return out
    if points.device.type == "cpu":
        _check_inputs(points, lengths, K, starts, max_K)
        return fps_plain(points, lengths, K, starts, max_K)
    raise ValueError(f"fps: no kernel for device {points.device}")


def fps_batched(points, lengths, K, starts, max_K: int):
    """One block per cloud (clouds of up to ``fps_limits(D, dev)[0]``
    points)."""
    return _dispatch(fps_batched, "block", points, lengths, K, starts, max_K)


def fps_resident(points, lengths, K, starts, max_K: int):
    """Every SM on one cloud at a time, the cloud in shared memory (clouds of
    up to ``fps_limits(D, dev)[1]`` points)."""
    return _dispatch(fps_resident, "resident", points, lengths, K, starts, max_K)


def fps_streaming(points, lengths, K, starts, max_K: int):
    """Every SM on one cloud at a time, streaming it from device memory
    every round (any size)."""
    return _dispatch(fps_streaming, "streaming", points, lengths, K, starts, max_K)


fps_batched.launches = 0
fps_resident.launches = 0
fps_streaming.launches = 0
