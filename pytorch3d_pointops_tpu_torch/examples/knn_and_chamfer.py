"""KNN and chamfer workflow: neighbour queries on ragged clouds, their
gradient, normal interpolation with ``knn_gather``, and 100 SGD steps of a
chamfer + normals fit; the port of the JAX package's
``examples/knn_and_chamfer.py``."""

from __future__ import annotations

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import (
    Pointclouds,
    chamfer_distance,
    knn_gather,
    knn_points,
    make_device,
)
from pytorch3d_pointops_tpu_torch.examples import check, parser

SIZES = (1000, 800)
STEPS = 100
LR = 0.5


def make_inputs(seed: int = 0) -> dict:
    """Two ragged clouds, one constant normal each, and the fit's starting
    noise (on the (2, 1000, 3) padded shape), as numpy."""
    rng = np.random.default_rng(seed)
    points = [rng.normal(size=(s, 3)).astype(np.float32) for s in SIZES]
    normals = [np.tile(np.float32([0, 0, 1]), (SIZES[0], 1)),
               np.tile(np.float32([0, 1, 0]), (SIZES[1], 1))]
    noise = rng.normal(size=(len(SIZES), max(SIZES), 3)).astype(np.float32)
    return {"points": points, "normals": normals, "noise": noise}


def chamfer_loss(p, target, lengths, normals):
    """The fit's loss: chamfer between ``p`` and ``target`` plus the normals
    term, with both clouds carrying ``normals``."""
    loss, feats = chamfer_distance(
        p, target, lengths, lengths,
        x_features={"normals": normals}, y_features={"normals": normals},
        feature_names=["normals"],
    )
    return loss + feats["normals"]


def fit(src, target, lengths, normals, steps: int = STEPS, lr: float = LR,
        log_every: int = 20):
    """Plain SGD on the points: ``steps`` loss-and-gradient evaluations,
    each followed by an update. Returns the losses, the first gradient and
    the last points."""
    p = src.detach().clone()
    losses, first_grad = [], None
    for i in range(steps):
        p.requires_grad_(True)
        loss = chamfer_loss(p, target, lengths, normals)
        (grad,) = torch.autograd.grad(loss, p)
        if first_grad is None:
            first_grad = grad
        with torch.no_grad():
            p = p - lr * grad
        losses.append(loss.item())
        if log_every and i % log_every == 0:
            print(f"iter {i:3d}  chamfer+normals loss {losses[-1]:.5f}")
    return losses, first_grad, p


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    data = make_inputs(seed)
    pc1 = Pointclouds(data["points"], features={"normals": data["normals"]}, device=dev)
    pc2 = Pointclouds([p + np.float32(0.05) for p in data["points"]],
                      features={"normals": data["normals"]}, device=dev)
    l1, l2 = pc1.num_points_per_cloud(), pc2.num_points_per_cloud()

    # KNN with ragged lengths, and its gradient into both clouds.
    p1 = pc1.points_padded().detach().clone().requires_grad_(True)
    p2 = pc2.points_padded().detach().clone().requires_grad_(True)
    out = knn_points(p1, p2, l1, l2, K=8)
    out.dists.mean().backward()
    print("knn dists:", tuple(out.dists.shape), "idx:", tuple(out.idx.shape))
    print(f"knn gradient norms: p1 {float(p1.grad.norm()):.6f}, "
          f"p2 {float(p2.grad.norm()):.6f}")

    # Each point's nearest neighbour in its own cloud is itself.
    self_nn = knn_points(pc1.points_padded(), pc1.points_padded(), l1, l1, K=1)
    self_max = float(self_nn.dists.max())
    check(self_max < 1e-5, f"self-KNN distance {self_max}")

    nn_normals = knn_gather(pc2.get_features_padded("normals"), out.idx, l2)
    interp = nn_normals.mean(dim=2)
    print("interpolated normals:", tuple(interp.shape))

    target = pc1.points_padded()
    src = target + 0.3 * torch.from_numpy(data["noise"]).to(dev)
    losses, first_grad, _ = fit(src, target, l1, pc1.get_features_padded("normals"))
    print("final loss:", losses[-1])
    check(np.isfinite(losses).all() and losses[-1] < losses[0], "the fit's loss did not fall")
    return {
        "knn_idx": out.idx.cpu().numpy(),
        "knn_dists": out.dists.detach().cpu().numpy(),
        "knn_grad_p1": p1.grad.cpu().numpy(),
        "knn_grad_p2": p2.grad.cpu().numpy(),
        "self_nn_max": self_max,
        "interp_normals": interp.cpu().numpy(),
        "first_loss": losses[0],
        "first_grad": first_grad.cpu().numpy(),
        "sgd_losses": losses[::20],
        "sgd_final_loss": losses[-1],
    }


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
