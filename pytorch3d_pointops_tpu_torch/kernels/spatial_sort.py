"""Morton (Z-order) codes and the sorts built on them, for the KNN kernel.

The port of ``pytorch3d_pointops_tpu/kernels/spatial_sort.py``. The KNN
kernel (``csrc/knn.cu``) gates its work per warp: one vote per group of
candidates decides for all of a warp's queries, so a warp pays for its least
coherent lane. Sorting the queries along a Morton curve puts neighbours in
one warp and block; sorting the candidates too, and starting each block's
scan in its own region, makes each query's kth distance nearly final after
the first tile (``kernels/knn.py``). The codes order work, never results.

The arithmetic is the JAX package's, in the same float32 steps and order,
so the codes are bit-equal to it: ``(p - lo) / max(hi - lo, 1e-12) * 1023``,
clipped to [0, 1023], truncated to an integer, 10 bits an axis
interleaved. The interleaving reads a table of every 10-bit value's spread
bits (a handful of launches on the card in place of some forty). Plain
PyTorch on every device: the JAX package sorts outside any kernel too.
"""

from __future__ import annotations

import functools

import torch

# Above every code of a point (3 x 10 bits): rows given it sort last.
PAD_CODE = 1 << 30


def _part1by2(u: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of u so consecutive bits land 3 apart."""
    u = (u | (u << 16)) & 0x030000FF
    u = (u | (u << 8)) & 0x0300F00F
    u = (u | (u << 4)) & 0x030C30C3
    u = (u | (u << 2)) & 0x09249249
    return u


@functools.lru_cache(maxsize=None)
def _spread(device: torch.device) -> torch.Tensor:
    """(3, 1024) int64 on ``device``: row a holds ``_part1by2(v) << a``."""
    v = _part1by2(torch.arange(1024, dtype=torch.int64))
    return torch.stack([v << a for a in range(3)]).to(device)


def morton_code(p: torch.Tensor, lo: torch.Tensor | None = None,
                hi: torch.Tensor | None = None) -> torch.Tensor:
    """(N, P, D) float32 -> (N, P) int32 Morton codes, 10 bits an axis, on
    the per-cloud bounding box or the explicit (N, 1, D) box ``lo``/``hi``
    (a joint box puts the codes of two clouds on one curve). D > 3 uses the
    first three axes."""
    p = p[..., :3]
    lo = p.amin(dim=1, keepdim=True) if lo is None else lo[..., :3]
    hi = p.amax(dim=1, keepdim=True) if hi is None else hi[..., :3]
    q = (p - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0
    q = q.clamp(0.0, 1023.0).to(torch.int64)
    table = _spread(p.device)
    # The axes' spread bits are disjoint, so their sum is their OR.
    axes = torch.arange(p.shape[2], device=p.device)
    return table[axes, q].sum(dim=-1, dtype=torch.int32)


def morton_order(p: torch.Tensor) -> torch.Tensor:
    """(N, P) int64: ``p[n, order[n]]`` is Morton-sorted on the per-cloud
    box. A stable sort: equal codes keep their row order."""
    return torch.argsort(morton_code(p), dim=1, stable=True)


def morton_argsort(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse), int64 (N, P): ``morton_order(p)``, and the inverse
    permutation, with which ``out[n, inverse[n]]`` restores the original row
    order."""
    order = morton_order(p)
    positions = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return order, torch.empty_like(order).scatter_(1, order, positions)
