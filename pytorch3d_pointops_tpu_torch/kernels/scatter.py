"""Deterministic row scatter-add: the Hopper kernel ``csrc/scatter.cu`` and
its plain PyTorch twin.

``out[n, idx[n, e], :] += contrib[n, e, :]`` over ``P2`` target rows, with
entries whose ``idx`` is negative skipped. Two entry points, one kernel:
``scatter_add_rows`` (the KNN backward's grad_p2 and the gather backward)
and ``scatter_add_k1`` (the chamfer K=1 backward), replacing
``pytorch3d_pointops_tpu/kernels/scatter_pallas.py`` ``scatter_add_rows`` /
``scatter_add_rows_pallas`` and ``kernels/chamfer_pallas.py``
``scatter_add_k1_pallas``. Each runs where its inputs are: a CUDA tensor
launches the kernel, a CPU tensor takes ``scatter_add_plain``; any other
device raises. The kernel's sums are bit-equal from run to run; the design
note is at the top of ``csrc/scatter.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def _check_inputs(idx, contrib, P2):
    if idx.dim() != 2 or contrib.dim() != 3 or idx.shape != contrib.shape[:2]:
        raise ValueError("idx must be (N, E) and contrib (N, E, C)")
    if not isinstance(P2, int) or P2 < 0:
        raise ValueError(f"P2 must be a non-negative int (got {P2!r})")


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
    """The kernel's index preparation: each row's entries sorted by target
    (skipped entries keyed ``P2``, after every real target), stably, so equal
    targets keep ascending entry order. Returns (sorted_keys, order), both
    (N, E) int64."""
    keys = torch.where(idx >= 0, idx, P2)
    order = torch.argsort(keys, dim=1, stable=True)
    return torch.gather(keys, 1, order), order


def _entry():
    fn = _build.load("scatter").scatter_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(idx, contrib, P2: int):
    """Sort the entries and launch ``csrc/scatter.cu`` on CUDA tensors:
    int64 idx and float32 contrib on one device."""
    _check_inputs(idx, contrib, P2)
    if not idx.is_cuda or contrib.device != idx.device:
        raise ValueError("the scatter kernel needs idx and contrib on one CUDA device")
    if idx.dtype != torch.int64 or contrib.dtype != torch.float32:
        raise ValueError("the scatter kernel needs int64 idx and float32 contrib")
    N, E, C = contrib.shape
    contrib = contrib.contiguous()
    sorted_keys, order = segment_plan(idx, P2)
    out = torch.empty((N, P2, C), dtype=torch.float32, device=idx.device)
    _build.check(
        _entry()(sorted_keys.data_ptr(), order.data_ptr(), contrib.data_ptr(),
                 N, E, P2, C, out.data_ptr(), _build.stream_ptr(idx.device)),
        "scatter_segment_sum",
    )
    return out


def _dispatch(wrapper, idx, contrib, P2):
    if idx.is_cuda:
        out = _launch(idx, contrib, P2)
        wrapper.launches += 1
        return out
    if idx.device.type == "cpu":
        _check_inputs(idx, contrib, P2)
        return scatter_add_plain(idx, contrib, P2)
    raise ValueError(f"scatter: no kernel for device {idx.device}")


def scatter_add_rows(idx, contrib, P2: int):
    """Deterministic ``out[n, idx[n, e]] += contrib[n, e]`` for the KNN
    backward: idx (N, E) int64, contrib (N, E, C) -> (N, P2, C)."""
    return _dispatch(scatter_add_rows, idx, contrib, P2)


def scatter_add_k1(idx, contrib, P2: int):
    """The same segment-sum for the chamfer K=1 backward: idx (N, P1)
    int64, contrib (N, P1, C) -> (N, P2, C)."""
    return _dispatch(scatter_add_k1, idx, contrib, P2)


scatter_add_rows.launches = 0
scatter_add_k1.launches = 0
