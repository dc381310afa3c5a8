"""The port's host-side C++ library: ``ctypes`` bindings of
``csrc/pointops_cpu.cpp``.

A copy of the JAX package's ``csrc/pointops_cpu.cpp``, byte for byte, built
with the same flags by ``_build.load_host`` into ``build/`` at the first
call. It is an implementation of the ops independent of both the plain
twins and the CUDA kernels (written from the documented semantics, run on
the host), so the tests and ``chip_smoke.py`` hold the kernels against it.
It is never on the ops' path.

Every function takes numpy arrays or CPU tensors and returns CPU tensors:
float32 values, int32 indices as the C side writes them. A host library
takes no CUDA tensor: a caller copies to the host itself. ``load()`` raises
``ImportError`` when there is no C++ compiler; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import _build

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_ARGTYPES = {
    "pointops_knn": [
        _f32p, _f32p, _i64p, _i64p, _i64, _i64, _i64, _i64, _i64,
        ctypes.c_int, _f32p, _i32p,
    ],
    "pointops_knn_backward": [
        _f32p, _f32p, _i64p, _i64p, _i32p, _f32p, _i64, _i64, _i64, _i64,
        _i64, ctypes.c_int, _f32p, _f32p,
    ],
    "pointops_ball_query": [
        _f32p, _f32p, _i64p, _i64p, _i64, _i64, _i64, _i64, _i64,
        ctypes.c_float, _f32p, _i32p,
    ],
    "pointops_fps": [_f32p, _i64p, _i64p, _i64p, _i64, _i64, _i64, _i64, _i32p],
    "pointops_packed_to_padded": [_f32p, _i64p, _i64, _i64, _i64, _i64, _f32p],
    "pointops_padded_to_packed": [_f32p, _i64p, _i64, _i64, _i64, _i64, _f32p],
    "pointops_sample_pdf": [
        _f32p, _f32p, _f32p, _i64, _i64, _i64, ctypes.c_float, _f32p,
    ],
}


@functools.cache
def load() -> ctypes.CDLL:
    """Compile (once) and load the library, its entry points typed. Raises
    ``ImportError`` when no C++ toolchain can build it."""
    lib = _build.load_host()
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def is_available() -> bool:
    try:
        load()
        return True
    except ImportError:
        return False


def _host(x, dtype) -> np.ndarray:
    """``x`` as a contiguous numpy array of ``dtype``; a tensor must lie on
    the CPU."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"native: the host library takes CPU tensors or numpy arrays, "
                f"not a tensor on {x.device}"
            )
        x = x.detach().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype)


def _lengths(lengths, N: int, P: int, what: str) -> np.ndarray:
    out = _host(lengths if lengths is not None else np.full(N, P), np.int64)
    if out.shape != (N,) or (out.size and (out.min() < 0 or out.max() > P)):
        raise ValueError(f"native: {what} must be ({N},) values in [0, {P}]")
    return out


def _clouds(p1, p2):
    p1, p2 = _host(p1, np.float32), _host(p2, np.float32)
    if p1.ndim != 3 or p2.ndim != 3 or p1.shape[0] != p2.shape[0] or (
            p1.shape[2] != p2.shape[2]):
        raise ValueError(f"native: clouds of shapes {p1.shape} and {p2.shape}")
    return p1, p2


def knn_points(
    p1, p2, lengths1=None, lengths2=None, K: int = 1, norm: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host KNN with ``ops.knn.knn_points``' conventions: (N, P1, K) float32
    dists and int32 idx, 0 past ``min(K, lengths2)`` and ``lengths1``."""
    lib = load()
    p1, p2 = _clouds(p1, p2)
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    lengths1 = _lengths(lengths1, N, P1, "lengths1")
    lengths2 = _lengths(lengths2, N, P2, "lengths2")
    dists = np.empty((N, P1, K), np.float32)
    idx = np.empty((N, P1, K), np.int32)
    lib.pointops_knn(p1, p2, lengths1, lengths2, N, P1, P2, D, K, norm, dists, idx)
    return torch.from_numpy(dists), torch.from_numpy(idx)


def knn_backward(
    p1, p2, idx, grad_dists, lengths1=None, lengths2=None, norm: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of the KNN (or ball query) distances into p1 and p2; idx -1
    and entries past the lengths contribute nothing."""
    lib = load()
    p1, p2 = _clouds(p1, p2)
    idx = _host(idx, np.int32)
    grad_dists = _host(grad_dists, np.float32)
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    if idx.ndim != 3 or idx.shape[:2] != (N, P1) or grad_dists.shape != idx.shape:
        raise ValueError(f"native: idx {idx.shape} and grad_dists "
                         f"{grad_dists.shape} must both be ({N}, {P1}, K)")
    if idx.size and idx.max() >= P2:
        raise ValueError(f"native: idx past the {P2} points of p2")
    K = idx.shape[2]
    lengths1 = _lengths(lengths1, N, P1, "lengths1")
    lengths2 = _lengths(lengths2, N, P2, "lengths2")
    grad_p1 = np.empty((N, P1, D), np.float32)
    grad_p2 = np.empty((N, P2, D), np.float32)
    lib.pointops_knn_backward(p1, p2, lengths1, lengths2, idx, grad_dists,
                              N, P1, P2, D, K, norm, grad_p1, grad_p2)
    return torch.from_numpy(grad_p1), torch.from_numpy(grad_p2)


def ball_query(
    p1, p2, lengths1=None, lengths2=None, K: int = 500, radius: float = 0.2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host ball query: the first K points in scan order with squared
    distance below ``radius * radius`` (squared in float32); idx -1 and
    dists 0 at pads."""
    lib = load()
    p1, p2 = _clouds(p1, p2)
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    lengths1 = _lengths(lengths1, N, P1, "lengths1")
    lengths2 = _lengths(lengths2, N, P2, "lengths2")
    dists = np.empty((N, P1, K), np.float32)
    idx = np.empty((N, P1, K), np.int32)
    lib.pointops_ball_query(p1, p2, lengths1, lengths2, N, P1, P2, D, K,
                            radius, dists, idx)
    return torch.from_numpy(dists), torch.from_numpy(idx)


def sample_farthest_points(points, lengths=None, K=50, start_idxs=None) -> torch.Tensor:
    """Host FPS; (N, max_K) int32 indices, -1-padded. ``K`` is an int or
    one count a cloud; ``start_idxs`` default to 0."""
    lib = load()
    points = _host(points, np.float32)
    if points.ndim != 3:
        raise ValueError(f"native: points of shape {points.shape}, not (N, P, D)")
    N, P, D = points.shape
    lengths = _lengths(lengths, N, P, "lengths")
    if np.ndim(K) == 0:
        K = np.full(N, int(K))
    K = _host(K, np.int64)
    max_K = int(K.max()) if K.size else 0
    start_idxs = _host(start_idxs if start_idxs is not None else np.zeros(N), np.int64)
    if K.shape != (N,) or start_idxs.shape != (N,):
        raise ValueError(f"native: K and start_idxs must be ({N},)")
    if np.any((np.minimum(K, lengths) > 0) & ((start_idxs < 0) | (start_idxs >= lengths))):
        raise ValueError("native: a start index lies outside its cloud")
    idx = np.empty((N, max_K), np.int32)
    lib.pointops_fps(points, lengths, K, start_idxs, N, P, D, max_K, idx)
    return torch.from_numpy(idx)


def _first_idxs(first_idxs, F: int) -> np.ndarray:
    first_idxs = _host(first_idxs, np.int64)
    if first_idxs.ndim != 1 or (first_idxs.size and (
            first_idxs[0] < 0 or first_idxs[-1] > F or np.any(np.diff(first_idxs) < 0))):
        raise ValueError(f"native: first_idxs must rise within [0, {F}]")
    return first_idxs


def packed_to_padded(inputs, first_idxs, max_size: int) -> torch.Tensor:
    """(F, ...) packed rows -> (N, max_size, ...) padded, zeros past each
    cloud."""
    lib = load()
    inputs = _host(inputs, np.float32)
    squeeze = inputs.ndim == 1
    if squeeze:
        inputs = inputs[:, None]
    lead = inputs.shape
    inputs2d = np.ascontiguousarray(inputs.reshape(lead[0], -1))
    F, D = inputs2d.shape
    first_idxs = _first_idxs(first_idxs, F)
    N = first_idxs.shape[0]
    out = np.empty((N, max_size, D), np.float32)
    lib.pointops_packed_to_padded(inputs2d, first_idxs, F, D, N, max_size, out)
    out = out.reshape(N, max_size, *lead[1:])
    return torch.from_numpy(out[..., 0] if squeeze else out)


def padded_to_packed(inputs, first_idxs, num_inputs: int) -> torch.Tensor:
    """(N, M, ...) padded -> (num_inputs, ...) packed rows."""
    lib = load()
    inputs = _host(inputs, np.float32)
    squeeze = inputs.ndim == 2
    if squeeze:
        inputs = inputs[..., None]
    lead = inputs.shape
    inputs3d = np.ascontiguousarray(inputs.reshape(lead[0], lead[1], -1))
    N, M, D = inputs3d.shape
    first_idxs = _first_idxs(first_idxs, num_inputs)
    if first_idxs.shape != (N,):
        raise ValueError(f"native: first_idxs must be ({N},)")
    out = np.empty((num_inputs, D), np.float32)
    lib.pointops_padded_to_packed(inputs3d, first_idxs, N, M, D, num_inputs, out)
    out = out.reshape(num_inputs, *lead[2:])
    return torch.from_numpy(out[..., 0] if squeeze else out)


def sample_pdf(bins, weights, uniforms, eps: float = 1e-5) -> torch.Tensor:
    """Host inverse-CDF sampling at the quantiles ``uniforms`` in [0, 1]
    (made by the caller): (..., S) float32 samples."""
    lib = load()
    bins = _host(bins, np.float32)
    weights = _host(weights, np.float32)
    uniforms = _host(uniforms, np.float32)
    batch_shape = weights.shape[:-1]
    n_bins = weights.shape[-1]
    S = uniforms.shape[-1]
    if bins.shape != (*batch_shape, n_bins + 1) or uniforms.shape[:-1] != batch_shape:
        raise ValueError(f"native: bins {bins.shape}, weights {weights.shape} and "
                         f"uniforms {uniforms.shape} do not match")
    B = int(np.prod(batch_shape)) if batch_shape else 1
    out = np.empty((B, S), np.float32)
    lib.pointops_sample_pdf(
        np.ascontiguousarray(bins.reshape(B, n_bins + 1)),
        np.ascontiguousarray(weights.reshape(B, n_bins)),
        np.ascontiguousarray(uniforms.reshape(B, S)), B, n_bins, S, eps, out,
    )
    return torch.from_numpy(out.reshape(*batch_shape, S))
