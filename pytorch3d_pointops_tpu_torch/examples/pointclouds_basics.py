"""Pointclouds container tour: construction from ragged lists, the three
views, indexing, ``update_padded`` and feature handling; the port of the
JAX package's ``examples/pointclouds_basics.py``."""

from __future__ import annotations

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import (
    Pointclouds,
    all_close,
    get_bounding_boxes,
    make_device,
)
from pytorch3d_pointops_tpu_torch.examples import check, parser

SIZES = (128, 256, 64)


def make_inputs(seed: int = 0) -> dict:
    """Ragged points, normals and colours of three clouds, as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "points": [rng.normal(size=(s, 3)).astype(f32) for s in SIZES],
        "normals": [rng.normal(size=(s, 3)).astype(f32) for s in SIZES],
        "colors": [rng.uniform(size=(s, 3)).astype(f32) for s in SIZES],
    }


def centroid_norms(pc: Pointclouds) -> torch.Tensor:
    """The norm of each cloud's centroid, from the padded view and a mask."""
    pts, lengths = pc.points_padded(), pc.num_points_per_cloud()
    mask = torch.arange(pts.shape[1], device=pts.device)[None] < lengths[:, None]
    com = (pts * mask[..., None]).sum(1) / lengths[:, None]
    return torch.linalg.norm(com, dim=-1)


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    data = make_inputs(seed)
    pc = Pointclouds(data["points"],
                     features={"normals": data["normals"], "colors": data["colors"]},
                     device=dev)
    out = {
        "batch_size": len(pc),
        "num_points": pc.num_points_per_cloud().tolist(),
        "padded_shape": tuple(pc.points_padded().shape),
        "packed_shape": tuple(pc.points_packed().shape),
        "feature_shapes": {k: tuple(v.shape) for k, v in pc.features_padded().items()},
        "first_idx": pc.cloud_to_packed_first_idx().tolist(),
    }
    for k, v in out.items():
        print(f"{k.replace('_', ' ')}: {v}")

    sub = pc[[0, 2]]
    out["subset_sizes"] = sub.num_points_per_cloud().tolist()
    print("subset sizes:", out["subset_sizes"])

    # A functional padded update, as after an optimisation step.
    moved = pc.update_padded(pc.points_padded() + 1.0)
    check("normals" in moved.features_padded(), "update_padded dropped the features")
    check(not all_close(pc, moved), "update_padded left the points where they were")

    boxes = get_bounding_boxes(pc)
    out["bounding_boxes"] = boxes.cpu().numpy()
    print("bounding boxes:", tuple(boxes.shape))

    norms = centroid_norms(pc)
    out["centroid_norms"] = norms.cpu().numpy()
    print("centroid norms:", out["centroid_norms"])
    return out


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
