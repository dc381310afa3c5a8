"""Ring-parallel point ops over a mesh: the scale-out layer; the port of
the JAX package's ``examples/ring_parallel.py``.

Query points are sharded over the ring axis ``sp`` and the reference
cloud's shards rotate around it, as in ring attention. The example shows:

1. a mesh: on the card a (2, 2) ``("dp", "sp")`` mesh of four positions on
   ``cuda:0``, which run one after another; on the CPU a (2, 4) mesh of
   eight CPU entries, as the JAX example's eight virtual devices;
2. ring KNN with global indices equal to the single-device op's;
3. a ring-chamfer fit: 50 SGD steps whose gradients flow through both ring
   passes;
4. feature channels over the ring.

With ``--process-mesh``, under ``torchrun``, parts 2-4 run on
``multihost.process_mesh``: one process a position of an ``("sp",)`` ring,
each holding its own blocks, every hop a send and a receive between
neighbouring ranks (NCCL between cards, gloo on the CPU):

    torchrun --nproc_per_node=2 -m pytorch3d_pointops_tpu_torch.examples.ring_parallel \\
        --device cpu --process-mesh
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import chamfer_distance, knn_points, make_device
from pytorch3d_pointops_tpu_torch.examples import check, parser
from pytorch3d_pointops_tpu_torch.parallel import (
    make_mesh,
    multihost,
    ring_chamfer_distance,
    ring_knn_points,
)
from pytorch3d_pointops_tpu_torch.parallel.mesh import NamedSharding

N, P1, P2 = 2, 256, 384
K = 8
STEPS, LR = 50, 30.0


def make_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "p1": rng.normal(size=(N, P1, 3)).astype(f32),
        "p2": rng.normal(size=(N, P2, 3)).astype(f32),
        "noise": rng.normal(size=(N, P2, 3)).astype(f32),
        "normals1": rng.normal(size=(N, P1, 3)).astype(f32),
        "normals2": rng.normal(size=(N, P2, 3)).astype(f32),
    }


def local_mesh(dev: torch.device):
    """The mesh of part 1: four positions of the one card, or eight of the
    CPU."""
    if dev.type == "cuda":
        return make_mesh((2, 2), ("dp", "sp"), devices=[dev] * 4)
    return make_mesh((2, 4), ("dp", "sp"), devices=[dev] * 8)


def main(device="cuda", seed: int = 0, process_mesh: bool = False) -> dict:
    dev = make_device(device)
    data = make_inputs(seed)
    if process_mesh:
        multihost.initialize()
        world = torch.distributed.get_world_size()
        mesh = multihost.process_mesh((world,), ("sp",),
                                      device=None if dev.type == "cuda" else dev)
        dev, batch_axis = mesh.device, None
        print(f"process mesh: {world} processes, this one rank "
              f"{torch.distributed.get_rank()} on {dev}")
    else:
        mesh, batch_axis = local_mesh(dev), "dp"
        print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} x {dev}")
    sh = NamedSharding(mesh, (batch_axis, "sp", None))
    T = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}

    # What the ring takes for a tensor: the blocks of every position on a
    # local mesh, this process's own block on a process mesh.
    block = sh.shard

    def own(t):
        """The points a process updates: the whole tensor on a local mesh
        (the ring shards it), this process's block on a process mesh."""
        return sh.shard(t).local if process_mesh else t

    def whole(t):
        """A ring output (or a process's block of points) as the whole
        tensor."""
        if process_mesh:
            return multihost.host_local_to_global(t, mesh, (None, "sp", None)).full()
        return t

    # ---- 2. ring KNN == single-device KNN, global indices and all ----
    ring = ring_knn_points(block(T["p1"]), block(T["p2"]), K=K, mesh=mesh,
                           point_axis="sp", batch_axis=batch_axis)
    single = knn_points(T["p1"], T["p2"], K=K)
    ring_idx, ring_dists = whole(ring.idx), whole(ring.dists)
    check(torch.equal(ring_idx, single.idx), "ring KNN indices differ from the single device's")
    check(torch.allclose(ring_dists, single.dists, atol=1e-5),
          "ring KNN distances differ from the single device's")
    print("ring KNN matches the single device exactly (tie order included)")

    # ---- 3. ring-chamfer training: fit a noisy cloud to a target ----
    # Mean reductions scale gradients by 1/(N*P): plain SGD needs a
    # learning rate of the order of the point count.
    target = block(T["p2"])
    pts = own(T["p2"] + 0.5 * T["noise"])
    losses = []
    for _ in range(STEPS):
        pts.requires_grad_(True)
        loss = ring_chamfer_distance(pts, target, mesh=mesh, point_axis="sp",
                                     batch_axis=batch_axis)
        (grad,) = torch.autograd.grad(loss, pts)
        with torch.no_grad():
            pts = pts - LR * grad
        losses.append(loss.item())
    print(f"ring-chamfer SGD: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(losses[-1] < 0.3 * losses[0], "the ring-chamfer fit did not converge")

    # The single device's chamfer on the fitted points.
    loss_single, _ = chamfer_distance(whole(pts), T["p2"])
    check(abs(loss_single.item() - losses[-1]) < 1e-3,
          f"the single device's loss {loss_single.item()} is not the ring's {losses[-1]}")

    # ---- 4. feature channels ride the ring too ----
    loss_f, lf = ring_chamfer_distance(
        block(T["p1"]), block(T["p2"]),
        x_features={"normals": block(T["normals1"])},
        y_features={"normals": block(T["normals2"])},
        feature_names=["normals"], mesh=mesh, point_axis="sp", batch_axis=batch_axis,
    )
    ref_loss, ref_lf = chamfer_distance(
        T["p1"], T["p2"], x_features={"normals": T["normals1"]},
        y_features={"normals": T["normals2"]}, feature_names=["normals"],
    )
    check(abs(loss_f.item() - ref_loss.item()) < 1e-4, "feature chamfer: loss")
    check(abs(lf["normals"].item() - ref_lf["normals"].item()) < 1e-4,
          "feature chamfer: normals")
    print(f"feature chamfer over the ring: loss={loss_f.item():.4f}, "
          f"normals={lf['normals'].item():.4f} (== single device)")
    print("OK")
    return {
        "ring_idx": ring_idx.cpu().numpy(),
        "ring_dists": ring_dists.cpu().numpy(),
        "first_loss": losses[0],
        "sgd_losses": losses[::10],
        "sgd_final_loss": losses[-1],
        "sgd_single_loss": loss_single.item(),
        "feature_loss": loss_f.item(),
        "feature_normals": lf["normals"].item(),
    }


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--process-mesh", action="store_true",
                    help="run on multihost.process_mesh, one process a position "
                         "(start it with torchrun)")
    args = ap.parse_args()
    try:
        main(args.device, args.seed, args.process_mesh)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
