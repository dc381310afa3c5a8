"""Inverse-CDF sampling: density-proportional samples of a two-bump
density, deterministic and random, ``sample_pdf`` against the NeRF variant
``sample_pdf_python`` and against the host library on the same quantiles;
the port of the JAX package's ``examples/sample_pdf_demo.py``."""

from __future__ import annotations

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import make_device, native, sample_pdf, sample_pdf_python
from pytorch3d_pointops_tpu_torch.examples import check, parser

N_BINS = 64


def density(device):
    """(1, 65) bin edges over [-3, 3] and (1, 64) weights of two bumps."""
    edges = torch.linspace(-3.0, 3.0, N_BINS + 1, device=device)
    centers = 0.5 * (edges[:-1] + edges[1:])
    weights = torch.exp(-((centers - 1.5) ** 2)) + 0.5 * torch.exp(
        -((centers + 1.5) ** 2) / 0.25
    )
    return edges[None], weights[None]


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    bins, w = density(dev)

    det = sample_pdf(bins, w, 16, det=True)
    print("det samples:", det[0].cpu().numpy().round(2))

    gen = torch.Generator(device=dev).manual_seed(seed)
    samples = sample_pdf(bins, w, 20000, det=False, generator=gen)
    edges = bins[0].cpu().numpy()
    hist, _ = np.histogram(samples[0].cpu().numpy(), bins=edges)
    top_bin = float(0.5 * (edges[:-1] + edges[1:])[hist.argmax()])
    print("histogram mode near 1.5:", top_bin)
    check(abs(top_bin - 1.5) < 0.3, f"the samples' mode {top_bin} is not near 1.5")

    a = sample_pdf(bins, w, 64, det=True)
    b = sample_pdf_python(bins, w, 64, det=True)
    diff_python = float((a - b).abs().max())
    print("max |sample_pdf - sample_pdf_python|:", diff_python)

    # The host library at the same quantiles, on host copies of the inputs.
    u = torch.linspace(0.0, 1.0, 64).expand(1, 64)
    host = native.sample_pdf(bins.cpu(), w.cpu(), u)
    diff_native = float((a.cpu() - host).abs().max())
    print("max |sample_pdf - native.sample_pdf|:", diff_native)
    check(diff_native <= 1e-5, f"sample_pdf and the host library differ by {diff_native}")
    return {
        "det_samples": det[0].cpu().numpy(),
        "top_bin": top_bin,
        "max_diff_python": diff_python,
        "max_diff_native": diff_native,
    }


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
