"""Arithmetic the plain references share: squared distances summed axis by
axis, and float32 rounded to TF32 for their controls. Plain ``torch``."""

from __future__ import annotations

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance of matching rows, (dx*dx + dy*dy) + dz*dz, each
    product and sum rounded on its own as the port's kernels round them."""
    t = a[..., 0] - b[..., 0]
    d = t * t
    for k in range(1, a.shape[-1]):
        t = a[..., k] - b[..., k]
        d = d + t * t
    return d


def tf32_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(Bx, By) distances |x|^2 + |y|^2 - 2 x.y from TF32-rounded inputs:
    what a tensor-core distance matrix computes."""
    xr, yr = tf32_round(x), tf32_round(y)
    return ((xr * xr).sum(-1)[:, None] + (yr * yr).sum(-1)[None, :]
            - 2.0 * (xr @ yr.T))


def key_of(d: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (distance, index) for distances >= 0: the
    float32 bits above, the index below."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | index
