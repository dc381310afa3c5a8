"""Inverse-CDF (NeRF-style) PDF sampling, in PyTorch.

The port of ``pytorch3d_pointops_tpu/ops/sample_pdf.py``, branch for branch:

* ``sample_pdf``: un-normalised partial sums, total weight + eps, a lower-
  bound search over the first ``n_bins - 1`` partial sums, then per-bin
  linear interpolation with the ``bin_weight > eps`` and overflow-to-bin-
  end special cases;
* ``sample_pdf_python``: the cumsum + searchsorted + lerp variant of the
  original NeRF sampler, kept as the cross-check.

Cumulative sums, searches and selects: plain PyTorch on every device (the
JAX package has no Pallas kernel here). Quantiles are uniformly spaced when
``det``, else drawn from the ``torch.Generator`` that takes the place of the
JAX package's PRNG key. Neither function is differentiable: the inputs are
detached, as the JAX package stops their gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import tracing


def _uniform_quantiles(batch_shape, n_samples: int, det: bool,
                       generator: Optional[torch.Generator],
                       device) -> torch.Tensor:
    """(*batch_shape, n_samples) float32 quantiles in [0, 1]: ``linspace``
    when ``det``, else uniform draws from ``generator`` (on its device)."""
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=device)
        return u.expand(*batch_shape, n_samples)
    if generator is None:
        raise ValueError("det=False requires a torch.Generator `generator`.")
    u = torch.rand((*batch_shape, n_samples), generator=generator,
                   device=generator.device, dtype=torch.float32)
    return u.to(device)


def _prepare(bins, weights):
    bins = torch.as_tensor(bins).detach().to(torch.float32)
    weights = torch.as_tensor(weights, device=bins.device).detach().to(torch.float32)
    batch_shape = bins.shape[:-1]
    n_bins = weights.shape[-1]
    if n_bins + 1 != bins.shape[-1] or weights.shape[:-1] != batch_shape:
        raise ValueError(
            "Inconsistent shapes of bins and weights: "
            f"{tuple(bins.shape)}{tuple(weights.shape)}"
        )
    return bins, weights, batch_shape, n_bins


@tracing.spanned("sample_pdf")
def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw ``n_samples`` per distribution from PDFs given by bin ``weights``
    over edges ``bins``.

    Args:
        bins: (..., n_bins+1) bin edges.
        weights: (..., n_bins) non-negative bin weights.
        n_samples: samples per distribution.
        det: uniformly spaced quantiles instead of random ones.
        eps: guard for empty bins.
        generator: the random source, required iff ``det=False``.

    Returns:
        (..., n_samples) float32 samples. Not differentiable.
    """
    bins, weights, batch_shape, n_bins = _prepare(bins, weights)
    u = _uniform_quantiles(batch_shape, n_samples, det, generator, bins.device)

    partial = torch.cumsum(weights, dim=-1)
    total = partial[..., -1:] + eps
    uniform = u * total
    # Lower bound over partial[..., :n_bins-1]: a bin in [0, n_bins - 1].
    i_bin = torch.searchsorted(partial[..., : n_bins - 1].contiguous(),
                               uniform.contiguous(), right=False)
    prev_sum = torch.where(
        i_bin > 0, torch.gather(partial, -1, (i_bin - 1).clamp(min=0)), 0.0
    )
    u_rem = uniform - prev_sum
    bin_start = torch.gather(bins, -1, i_bin)
    bin_end = torch.gather(bins, -1, i_bin + 1)
    bin_weight = torch.gather(weights, -1, i_bin)
    lerped = bin_start + (
        u_rem / torch.where(bin_weight > eps, bin_weight, 1.0)
    ) * (bin_end - bin_start)
    return torch.where(
        u_rem > bin_weight,
        bin_end,
        torch.where(bin_weight > eps, lerped, bin_start),
    )


@tracing.spanned("sample_pdf_python")
def sample_pdf_python(
    bins: torch.Tensor,
    weights: torch.Tensor,
    N_samples: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The cumsum + searchsorted + lerp variant of ``sample_pdf`` (the
    original NeRF sampler): same arguments, a normalised CDF with eps added
    to every weight."""
    bins, weights, batch_shape, _ = _prepare(bins, weights)
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = _uniform_quantiles(batch_shape, N_samples, det, generator, bins.device)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)

    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, 1.0, denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
