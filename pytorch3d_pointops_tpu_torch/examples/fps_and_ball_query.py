"""PointNet++-style set abstraction: farthest point sampling of centroids,
a ball query around them and the grouping's gradient into the points; the
port of the JAX package's ``examples/fps_and_ball_query.py`` (BASELINE
config 2's workload)."""

from __future__ import annotations

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import (
    ball_query,
    make_device,
    masked_gather,
    sample_farthest_points,
    sample_farthest_points_naive,
)
from pytorch3d_pointops_tpu_torch.examples import check, parser

N, P = 4, 4096
K_FPS, K_BALL, RADIUS = 512, 32, 0.2


def make_inputs(seed: int = 0) -> dict:
    """Four clouds of up to 4,096 points (lengths P, P/2, P, 3P/4) and
    their colours, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "points": rng.normal(size=(N, P, 3)).astype(np.float32),
        "lengths": np.array([P, P // 2, P, 3 * P // 4], np.int64),
        "colors": rng.uniform(size=(N, P, 3)).astype(np.float32),
    }


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    data = make_inputs(seed)
    points = torch.from_numpy(data["points"]).to(dev).requires_grad_(True)
    lengths = torch.from_numpy(data["lengths"]).to(dev)

    centroids, idx = sample_farthest_points(points, lengths, K=K_FPS)
    pads = int((idx == -1).sum())
    print("centroids:", tuple(centroids.shape), "idx pad count:", pads)

    # The same indices as the one-cloud-at-a-time numpy oracle.
    _, idx_naive = sample_farthest_points_naive(points.detach(), lengths, K=K_FPS)
    check(torch.equal(idx, idx_naive), "FPS differs from sample_farthest_points_naive")

    colors = torch.from_numpy(data["colors"]).to(dev)
    centroid_colors = masked_gather(colors, idx)
    print("centroid colors:", tuple(centroid_colors.shape))

    # Each point's first 32 centroids within r = 0.2, as the JAX example
    # queries them.
    grouped = ball_query(points, centroids, lengths1=lengths, K=K_BALL, radius=RADIUS)
    valid = grouped.idx >= 0
    in_radius = grouped.dists.detach()[valid]
    max_d2 = float(in_radius.max()) if in_radius.numel() else None
    print("grouped:", tuple(grouped.knn.shape), "max dist^2:", max_d2)
    check(bool((in_radius < RADIUS**2).all()),
          f"an in-radius squared distance {max_d2} is at or past r^2")

    # The grouping is differentiable: the distances' sum back into the
    # points, through the ball query and the centroids' gather.
    grouped.dists.sum().backward()
    grad_norm = float(points.grad.norm())
    print(f"grouping gradient norm: {grad_norm:.6f}")

    # Random starts come from a torch.Generator on the device.
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    _, idx_rand = sample_farthest_points(points.detach(), lengths, K=16,
                                         random_start_point=True, generator=gen)
    print("random-start firsts:", idx_rand[:, 0].tolist())
    return {
        "fps_idx": idx.cpu().numpy(),
        "pad_count": pads,
        "ball_idx": grouped.idx.cpu().numpy(),
        "ball_dists": grouped.dists.detach().cpu().numpy(),
        "max_dist2": max_d2,
        "grad": points.grad.cpu().numpy(),
        "random_firsts": idx_rand[:, 0].cpu().numpy(),
    }


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
