"""Bidirectional K=1 nearest neighbours for the chamfer loss: the Hopper
kernel ``csrc/chamfer_nn.cu`` and its plain PyTorch twin.

One distance pass gives both directions: for every valid x point its nearest
valid y point, and for every valid y point its nearest valid x point, with
the lowest index on ties. ``chamfer_nn_bidirectional`` runs where its inputs
are: a CUDA tensor launches the kernel, a CPU tensor takes
``chamfer_nn_plain``; any other device raises. Returns raw
(d_xy (N, P1), i_xy (N, P1), d_yx (N, P2), i_yx (N, P2)) with int64
indices and (inf, 0) where a point has no valid partner or is itself past
its cloud's length; callers apply the pad conventions.

The kernel replaces ``pytorch3d_pointops_tpu/kernels/chamfer_pallas.py``
``chamfer_nn_bidirectional_pallas``; the design note is at the top of
``csrc/chamfer_nn.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, tracing
from .knn import pairwise_dist

_INF = float("inf")
# x rows per chunk of the plain version's distance matrix.
_PLAIN_CHUNK = 2048


def _check_inputs(x, y, lengths1, lengths2, norm):
    if norm not in (1, 2):
        raise ValueError("Support for 1 or 2 norm.")
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0]:
        raise ValueError("x and y must be (N, P1, D) and (N, P2, D)")
    if x.shape[2] != y.shape[2]:
        raise ValueError("x and y must have the same point dimension")
    N = x.shape[0]
    if lengths1.shape != (N,) or lengths2.shape != (N,):
        raise ValueError("lengths1 and lengths2 must be of shape (N,)")


def chamfer_nn_plain(x, y, lengths1, lengths2, norm: int):
    """Plain PyTorch twin, on any device: per cloud, chunks of x rows
    against all of y, one jointly masked distance tile per chunk serving
    both directions; strict < across ascending chunks keeps the lowest x
    index for the y -> x side. Where x or y has no point, every point has
    no partner: (inf, 0), as the kernel gives."""
    N, P1, _ = x.shape
    P2 = y.shape[1]
    d_xy = x.new_full((N, P1), _INF)
    i_xy = torch.zeros((N, P1), dtype=torch.int64, device=x.device)
    d_yx = x.new_full((N, P2), _INF)
    i_yx = torch.zeros((N, P2), dtype=torch.int64, device=x.device)
    if P1 == 0 or P2 == 0:
        return d_xy, i_xy, d_yx, i_yx
    jv = torch.arange(P2, device=x.device)
    for n in range(N):
        yvalid = jv < lengths2[n]
        for a in range(0, P1, _PLAIN_CHUNK):
            xc = x[n, a : a + _PLAIN_CHUNK]
            iv = torch.arange(a, a + xc.shape[0], device=x.device)
            xvalid = iv < lengths1[n]
            d = pairwise_dist(xc, y[n], norm)
            d = torch.where(xvalid[:, None] & yvalid[None, :], d, _INF)
            rmin, rarg = d.min(dim=1)
            keep = xvalid & (rmin < _INF)
            d_xy[n, a : a + xc.shape[0]] = torch.where(keep, rmin, _INF)
            i_xy[n, a : a + xc.shape[0]] = torch.where(keep, rarg, 0)
            cmin, carg = d.min(dim=0)
            better = cmin < d_yx[n]
            d_yx[n] = torch.where(better, cmin, d_yx[n])
            i_yx[n] = torch.where(better, carg + a, i_yx[n])
    return d_xy, i_xy, d_yx, i_yx


def _entry():
    fn = _build.load("chamfer_nn").chamfer_nn_bidir
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ] * 7
    fn.restype = ctypes.c_int
    return fn


def chamfer_nn_cuda(x, y, lengths1, lengths2, norm: int):
    """Launch ``csrc/chamfer_nn.cu`` on CUDA tensors: float32 points, int64
    lengths, all contiguous and on one device. At D = 3 the distance pass
    keeps each point's minimum and the 128-point sub-tile that holds it, and
    a rescan of that sub-tile finds the index: counted, every point of both
    sides, in ``chamfer.rescan_points``."""
    _check_inputs(x, y, lengths1, lengths2, norm)
    for t, dtype in ((x, torch.float32), (y, torch.float32),
                     (lengths1, torch.int64), (lengths2, torch.int64)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("chamfer_nn_cuda needs every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"chamfer_nn_cuda needs contiguous {dtype} inputs")
    N, P1, D = x.shape
    P2 = y.shape[1]
    dev = x.device
    key_x = torch.empty((N, P1), dtype=torch.int64, device=dev)
    key_y = torch.empty((N, P2), dtype=torch.int64, device=dev)
    d_xy = torch.empty((N, P1), dtype=torch.float32, device=dev)
    i_xy = torch.empty((N, P1), dtype=torch.int64, device=dev)
    d_yx = torch.empty((N, P2), dtype=torch.float32, device=dev)
    i_yx = torch.empty((N, P2), dtype=torch.int64, device=dev)
    _build.check(
        _entry()(x.data_ptr(), y.data_ptr(), lengths1.data_ptr(),
                 lengths2.data_ptr(), N, P1, P2, D, norm, key_x.data_ptr(),
                 key_y.data_ptr(), d_xy.data_ptr(), i_xy.data_ptr(),
                 d_yx.data_ptr(), i_yx.data_ptr(), _build.stream_ptr(dev)),
        "chamfer_nn_bidir",
    )
    tracing.launch("chamfer_nn_cuda")
    if D == 3:
        tracing.count("chamfer.rescan_points", N * (P1 + P2))
    return d_xy, i_xy, d_yx, i_yx


@tracing.spanned("chamfer_nn")
def chamfer_nn_bidirectional(x, y, lengths1, lengths2, norm: int):
    """Both K=1 nearest-neighbour directions: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.is_cuda:
        return chamfer_nn_cuda(x, y, lengths1, lengths2, norm)
    if x.device.type == "cpu":
        _check_inputs(x, y, lengths1, lengths2, norm)
        return chamfer_nn_plain(x, y, lengths1, lengths2, norm)
    raise ValueError(f"chamfer_nn_bidirectional: no kernel for device {x.device}")
