"""Local covariances and their eigen-structure: per-point covariances over
K=16 neighbourhoods (``get_point_covariances``, KNN underneath) of a
sphere, an ellipsoid squashed along z and a noisy line, whose eigenvalues
recover the generating geometry; the port of the JAX package's
``examples/covariances_demo.py``."""

from __future__ import annotations

import numpy as np

from pytorch3d_pointops_tpu_torch import Pointclouds, get_point_covariances, make_device
from pytorch3d_pointops_tpu_torch.examples import check, parser

K = 16
NAMES = ("sphere", "ellipsoid(z*0.1)", "line")


def make_inputs(seed: int = 0, n: int = 800) -> list:
    """The three clouds of ``n`` points, as numpy."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    sphere = v / np.linalg.norm(v, axis=1, keepdims=True)
    # Squashed along z, the ellipsoid curls tightly at its equator, so its
    # neighbourhoods span three dimensions.
    ellipsoid = sphere * np.float32([1.0, 1.0, 0.1])
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    line = (t * np.float32([2.0, 1.0, 0.5])
            + np.float32(0.001) * rng.normal(size=(n, 3)).astype(np.float32))
    return [sphere, ellipsoid, line.astype(np.float32)]


def shape_descriptors(cov: np.ndarray) -> dict:
    """Linearity, planarity and sphericity from the eigenvalues in
    descending order."""
    eigvals = np.linalg.eigvalsh(cov)  # ascending
    l3, l2, l1 = eigvals[:, 0], eigvals[:, 1], eigvals[:, 2]
    eps = 1e-8
    return {
        "linearity": (l1 - l2) / (l1 + eps),
        "planarity": (l2 - l3) / (l1 + eps),
        "sphericity": l3 / (l1 + eps),
        "eigvals": (l1, l2, l3),
    }


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    pc = Pointclouds(make_inputs(seed), device=dev)
    lengths = pc.num_points_per_cloud()
    cov, _ = get_point_covariances(pc.points_padded(), lengths, K)
    print(f"covariances: {tuple(cov.shape)}  (neighbourhoods of K={K})")

    cov_np = cov.cpu().numpy()
    stats, out = {}, {"covariances": cov_np}
    for i, name in enumerate(NAMES):
        n = int(lengths[i])
        d = shape_descriptors(cov_np[i, :n])
        l1, l2, l3 = d["eigvals"]
        print(f"\n{name} ({n} pts):")
        print(f"  mean eigenvalues l1:l2:l3 = {l1.mean():.5f}:{l2.mean():.5f}:{l3.mean():.5f}")
        for k in ("linearity", "planarity", "sphericity"):
            print(f"  {k:10s}: {d[k].mean():.3f} +- {d[k].std():.3f}")
            out[f"{name}_{k}"] = float(d[k].mean())
        stats[name] = d

    # The line is the most linear shape, the sphere's patches the most
    # planar; the squashed ellipsoid's neighbourhoods are far more
    # spherical than the sphere's.
    line, sphere, ell = stats["line"], stats["sphere"], stats["ellipsoid(z*0.1)"]
    check(line["linearity"].mean() > 0.9, "the line is not linear")
    check(line["linearity"].mean() > sphere["linearity"].mean(),
          "the sphere is more linear than the line")
    check(sphere["planarity"].mean() > line["planarity"].mean(),
          "the line is more planar than the sphere")
    check(ell["sphericity"].mean() > 5 * sphere["sphericity"].mean(),
          "the ellipsoid is not more spherical than the sphere")
    print("\neigen-structure invariants hold")
    return out


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
