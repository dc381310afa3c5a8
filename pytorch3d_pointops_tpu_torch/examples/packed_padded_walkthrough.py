"""Packed <-> padded walkthrough: clouds of several sizes with a named
feature channel, their packed views from ``Pointclouds``, a round trip
through ``packed_to_padded`` / ``padded_to_packed`` that must be exact, the
gradient through the conversion, and the padding's share; the port of the
JAX package's ``examples/packed_padded_walkthrough.py``."""

from __future__ import annotations

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import (
    Pointclouds,
    make_device,
    packed_to_padded,
    padded_to_packed,
)
from pytorch3d_pointops_tpu_torch.examples import check, parser

SIZES = (120, 75, 200, 33)


def make_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "points": [rng.normal(size=(s, 3)).astype(np.float32) for s in SIZES],
        "intensities": [rng.uniform(size=(s, 1)).astype(np.float32) for s in SIZES],
    }


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    data = make_inputs(seed)
    pc = Pointclouds(data["points"], features={"intensities": data["intensities"]},
                     device=dev)

    points_packed = pc.points_packed()
    inten_packed = pc.get_features_packed("intensities")
    lengths = pc.num_points_per_cloud()
    first_idxs = pc.cloud_to_packed_first_idx()
    total = int(lengths.sum())
    max_size = int(lengths.max())
    print(f"clouds: {len(pc)}, points per cloud: {lengths.tolist()}")
    print(f"packed points: {tuple(points_packed.shape)}, "
          f"packed intensities: {tuple(inten_packed.shape)}")

    points_padded = packed_to_padded(points_packed, first_idxs, max_size)
    inten_padded = packed_to_padded(inten_packed, first_idxs, max_size)
    print(f"padded points: {tuple(points_padded.shape)}, "
          f"padded intensities: {tuple(inten_padded.shape)}")

    # Both directions are gathers: the round trip moves values, it rounds none.
    check(torch.equal(padded_to_packed(points_padded, first_idxs, total), points_packed),
          "points round trip")
    check(torch.equal(padded_to_packed(inten_padded, first_idxs, total), inten_packed),
          "intensities round trip")
    check(torch.equal(pc.points_padded(), points_padded),
          "packed_to_padded against Pointclouds.points_padded")
    print("round trip exact (and equal to Pointclouds.points_padded)")

    # Each direction's gradient is the other direction.
    packed = points_packed.detach().clone().requires_grad_(True)
    packed_to_padded(packed, first_idxs, max_size).sum().backward()
    check(bool((packed.grad == 1.0).all()), "packed_to_padded gradient is not all ones")
    print("packed_to_padded gradient = ones (the transposed op)")

    total_elements = points_padded.numel()
    valid_elements = points_packed.numel()
    ratio = (total_elements - valid_elements) / total_elements
    print(f"padding ratio: {ratio:.2%} ({total_elements} padded vs "
          f"{valid_elements} valid elements)")
    return {
        "num_points": lengths.tolist(),
        "packed_shape": tuple(points_packed.shape),
        "padded_shape": tuple(points_padded.shape),
        "padded_points": points_padded.cpu().numpy(),
        "padding_ratio": ratio,
    }


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
