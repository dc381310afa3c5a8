"""The one generator of the benchmark's traffic: point clouds from a seed.

Every cell's traffic is a JSON object of parameters (``workloads/<cell>.json``,
key ``traffic``); the pipelines hand its cloud specs to ``clouds`` and get
padded (N, P, D) points, their lengths and their features back. Bulk data is
drawn on the device from one ``torch.Generator`` seeded by ``--seed``.

A cloud spec:

    {"batch": 32, "points": 16384, "lengths": "full", "scale": 1.5}

``lengths`` is ``"full"`` (every cloud has ``points``) or an explicit list
of ``batch`` lengths, so every seed does the same amount of work. Points are
Gaussian times ``scale``; padding past a cloud's length is 0, as
``Pointclouds`` pads.
"""

from __future__ import annotations

import torch

SEED_MASK = 2**63 - 1


def generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(device generator, host generator), both seeded from ``seed``."""
    dev = torch.Generator(device=device)
    dev.manual_seed(seed & SEED_MASK)
    host = torch.Generator()
    host.manual_seed((seed * 0x9E3779B1 + 1) & SEED_MASK)
    return dev, host


def lengths_of(spec: dict) -> list[int]:
    """The (batch,) lengths a spec asks for, as host ints."""
    n, p, lengths = spec["batch"], spec["points"], spec.get("lengths", "full")
    if lengths == "full":
        return [p] * n
    if len(lengths) != n or max(lengths) > p or min(lengths) < 0:
        raise ValueError(f"lengths {lengths} do not fit batch {n} x {p}")
    return list(lengths)


def pad_mask(lengths: list[int], p: int, device) -> torch.Tensor:
    """(N, P, 1) float mask, 1 inside each cloud."""
    lens = torch.tensor(lengths, device=device)
    return (torch.arange(p, device=device)[None, :] < lens[:, None])[..., None].float()


def cloud(spec: dict, dev: torch.Generator, device,
          dim: int = 3) -> tuple[torch.Tensor, list[int]]:
    """Padded (N, P, dim) float32 points and their host lengths."""
    lengths = lengths_of(spec)
    pts = torch.randn((spec["batch"], spec["points"], dim), generator=dev, device=device)
    pts = pts * spec.get("scale", 1.0)
    return pts * pad_mask(lengths, spec["points"], device), lengths


def features(kinds: dict, n: int, p: int, lengths: list[int], dev: torch.Generator,
             device) -> dict:
    """Named (N, P, 3) feature channels: ``unit_gaussian`` (unit directions)
    or ``uniform`` (in [0, 1)), 0 past each cloud's length."""
    mask = pad_mask(lengths, p, device)
    out = {}
    for name, kind in kinds.items():
        if kind == "unit_gaussian":
            f = torch.randn((n, p, 3), generator=dev, device=device)
            f = f / f.norm(dim=-1, keepdim=True)
        elif kind == "uniform":
            f = torch.rand((n, p, 3), generator=dev, device=device)
        else:
            raise ValueError(f"unknown feature kind {kind!r}")
        out[name] = f * mask
    return out
