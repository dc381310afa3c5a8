"""The cases of ``test_torch_ring_procs.py``, and the ranks that run them.

Each case makes its numpy inputs from a seed and runs the port's ring on a
mesh through ``put``, which hands the ring what a caller would: on a
``ProcessMesh`` this process's block of each input, on a mesh of one
process's devices the whole input. A case returns ``{name: (tensor,
spec)}``, where ``spec`` says how a process-mesh output is split (``None``
for a value that is the same on every process).

Run as a script, it spawns four gloo ranks on the CPU; each runs every case
on the process meshes and saves its outputs to ``<out>/rank<r>.pt``:

    python tests/ring_procs_cases.py <out dir>

It imports neither JAX nor the JAX package, so the ranks start quickly.
"""

from __future__ import annotations

import functools
import itertools
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from pytorch3d_pointops_tpu_torch.parallel import (  # noqa: E402
    multihost,
    ring_chamfer_distance,
    ring_knn_gather,
    ring_knn_points,
)
from pytorch3d_pointops_tpu_torch.parallel.mesh import NamedSharding  # noqa: E402

WORLD = 4
MESHES = {"sp": ((4,), ("sp",)), "dp_sp": ((2, 2), ("dp", "sp"))}
SP = (None, "sp", None)
DP_SP = ("dp", "sp", None)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _leaf(put, a, spec):
    """The ring's view of ``a``, a leaf that takes gradients."""
    return put(a, spec).detach().clone().requires_grad_(True)


# ----------------------------- inputs -----------------------------

def knn_inputs(K, norm, P1=32, P2=128, l1=(32, 9, 31), l2=(0, 31, 127)):
    """Ragged clouds: by default lengths2 0, 31 (three of four shards past
    the length) and P2 - 1; lengths1 9 (two shards past it) and P1 - 1."""
    rng = np.random.default_rng(10 * K + norm)
    N = len(l1)
    return dict(
        p1=rng.normal(size=(N, P1, 3)).astype(np.float32),
        p2=rng.normal(size=(N, P2, 3)).astype(np.float32),
        l1=np.array(l1), l2=np.array(l2),
        w=rng.normal(size=(N, P1, K)).astype(np.float32),
        wn=rng.normal(size=(N, P1, K, 3)).astype(np.float32),
    )


def gather_inputs():
    rng = np.random.default_rng(15)
    return dict(
        x=rng.normal(size=(2, 64, 5)).astype(np.float32),
        idx=rng.integers(0, 64, size=(2, 32, 3)),
        lengths=np.array([64, 2]),
        w=rng.normal(size=(2, 32, 3, 5)).astype(np.float32),
    )


def unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def chamfer_inputs(seed=4, N=2, P1=48, P2=64, lx=(48, 10), ly=(64, 3)):
    """Ragged clouds (lengths that leave whole shards empty) with normals
    and colors."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(N, P1, 3)).astype(np.float32),
        y=rng.normal(size=(N, P2, 3)).astype(np.float32),
        lx=np.array(lx), ly=np.array(ly),
        xn=unit(rng.normal(size=(N, P1, 3))), yn=unit(rng.normal(size=(N, P2, 3))),
        xc=rng.uniform(size=(N, P1, 3)).astype(np.float32),
        yc=rng.uniform(size=(N, P2, 3)).astype(np.float32),
        wx=rng.normal(size=(N, P1)).astype(np.float32),
        wy=rng.normal(size=(N, P2)).astype(np.float32),
    )


def tied_max_inputs():
    """A Hausdorff maximum tied across two ranks: x rows 2 (rank 0's block)
    and 26 (rank 2's) sit at (5, 0, 0) and (-5, 0, 0), and y is symmetric
    (y and -y), so their nearest distances are equal to the last bit and
    exceed every other term in both directions."""
    d = chamfer_inputs(seed=31)
    rng = np.random.default_rng(32)
    half = (0.5 * rng.normal(size=(2, 32, 3))).astype(np.float32)
    d["y"] = np.concatenate([half, -half], axis=1)
    d["x"] = (0.3 * rng.normal(size=(2, 48, 3))).astype(np.float32)
    d["x"][:, 2] = (5.0, 0.0, 0.0)
    d["x"][:, 26] = (-5.0, 0.0, 0.0)
    d["lx"], d["ly"] = np.array([48, 30]), np.array([64, 64])
    return d


# ----------------------------- runs -----------------------------

def run_knn(d, mesh, put, K, norm, batch_axis=None, spec=SP):
    """Forward and backward, with ``return_nn``: the loss weighs every
    distance and gathered neighbour coordinate."""
    a, b = _leaf(put, d["p1"], spec), _leaf(put, d["p2"], spec)
    out = ring_knn_points(a, b, _t(d["l1"]), _t(d["l2"]), norm=norm, K=K,
                          mesh=mesh, batch_axis=batch_axis, return_nn=True)
    # On a process mesh each process sums its own block's terms: the
    # gradient of the global sum with respect to that block.
    loss = (out.dists * put(d["w"], spec)).sum() + (
        out.knn * put(d["wn"], spec + (None,))).sum()
    loss.backward()
    return {"dists": (out.dists, spec), "idx": (out.idx, spec),
            "knn": (out.knn, spec + (None,)), "grad_p1": (a.grad, spec),
            "grad_p2": (b.grad, spec)}


def run_gather(d, mesh, put):
    x = _leaf(put, d["x"], SP)
    out = ring_knn_gather(x, put(d["idx"], SP), _t(d["lengths"]), mesh=mesh)
    (out * put(d["w"], SP + (None,))).sum().backward()
    return {"gathered": (out, SP + (None,)), "grad_x": (x.grad, SP)}


def run_chamfer(d, mesh, put, features=False, batch_axis=None, spec=SP, **kw):
    x, y = _leaf(put, d["x"], spec), _leaf(put, d["y"], spec)
    feats = {}
    if features:
        feats = {k: _leaf(put, d[k], spec) for k in ("xn", "xc", "yn", "yc")}
        kw.update(x_features={"normals": feats["xn"], "colors": feats["xc"]},
                  y_features={"normals": feats["yn"], "colors": feats["yc"]},
                  feature_names=["normals", "colors"])
    if "weights" in kw:
        kw["weights"] = _t(kw["weights"])
    out = ring_chamfer_distance(x, y, _t(d["lx"]), _t(d["ly"]), mesh=mesh,
                                batch_axis=batch_axis, **kw)
    loss, lf = out if features else (out, None)
    res = {}
    if kw.get("point_reduction", "mean") is None:
        cx, cy = loss if isinstance(loss, tuple) else (loss, None)
        total = (cx * put(d["wx"], spec[:2])).sum()
        res["terms_x"] = (cx, spec[:2])
        if cy is not None:
            total = total + (cy * put(d["wy"], spec[:2])).sum()
            res["terms_y"] = (cy, spec[:2])
    else:
        total = loss + (lf["normals"] + lf["colors"] if features else 0.0)
        res["loss"] = (total.reshape(-1), None)
    total.sum().backward()
    # Zero weights return zeros from x alone: y gets no gradient.
    for k, v in dict(x=x, y=y, **feats).items():
        res[f"grad_{k}"] = (torch.zeros_like(v) if v.grad is None else v.grad, spec)
    return res


def run_bit_equal(mesh, put):
    """Two backward runs of ring KNN and of the ring chamfer with features:
    the gradients of each pair are bit-equal."""
    runs = [dict(**run_case("knn-K8-norm2", mesh, put),
                 **{f"c_{k}": v for k, v in run_case(
                     "chamfer-features-abs-cosine", mesh, put).items()})
            for _ in range(2)]
    return {f"{k}_run{i}": v for i, run in enumerate(runs)
            for k, v in run.items() if k.startswith(("grad", "c_grad"))}


def _cases():
    """``{name: (mesh, inputs, kind, keywords)}``: a case runs
    ``RUNS[kind](inputs(), mesh, put, **keywords)``."""
    cases = {}
    for K, norm in itertools.product((1, 8, 100), (1, 2)):
        cases[f"knn-K{K}-norm{norm}"] = (
            "sp", functools.partial(knn_inputs, K, norm), "knn", dict(K=K, norm=norm))
    cases["gather"] = ("sp", gather_inputs, "gather", {})
    for name, kw in {
        "mean": {},
        "sum": dict(point_reduction="sum", batch_reduction="sum"),
        "weights": dict(weights=[0.5, 2.0]),
        "zero-weights": dict(weights=[0.0, 0.0]),
        "unreduced": dict(point_reduction=None, batch_reduction=None),
        "single-directional": dict(single_directional=True),
        "features-abs-cosine": dict(features=True, abs_cosine=True),
        "features-signed-cosine": dict(features=True, abs_cosine=False),
    }.items():
        cases[f"chamfer-{name}"] = ("sp", chamfer_inputs, "chamfer", kw)
    cases["chamfer-max-tied-across-ranks"] = (
        "sp", tied_max_inputs, "chamfer", dict(point_reduction="max"))
    cases["mesh2x2-knn"] = (
        "dp_sp", functools.partial(knn_inputs, 4, 2, P2=64, l1=(32, 5, 17, 1),
                                   l2=(64, 0, 33, 63)),
        "knn", dict(K=4, norm=2, batch_axis="dp", spec=DP_SP))
    # Weights whose first batch block sums to 0: the zero-weights shortcut
    # must be decided on the global sum.
    cases["mesh2x2-chamfer"] = (
        "dp_sp", functools.partial(chamfer_inputs, seed=9, N=4, lx=(48, 10, 1, 47),
                                   ly=(64, 3, 0, 63)),
        "chamfer", dict(features=True, batch_axis="dp", spec=DP_SP,
                        weights=[0.0, 0.0, 1.0, 2.0]))
    return cases


CASES = _cases()
RUNS = {"knn": run_knn, "gather": run_gather, "chamfer": run_chamfer}


def run_case(name, mesh, put):
    _, inputs, kind, kw = CASES[name]
    return RUNS[kind](inputs(), mesh, put, **kw)


# ----------------------------- the ranks -----------------------------

def process_put(mesh):
    def put(a, spec):
        return NamedSharding(mesh, spec).shard(torch.as_tensor(np.asarray(a))).local
    return put


def check_host_local_to_global(mesh, put):
    """``host_local_to_global`` keeps this process's block (nothing
    gathered), ``global_to_host_local`` gives it back, ``full()`` gathers it
    explicitly, and the ring takes the result as it takes the blocks."""
    d = knn_inputs(4, 2)
    blocks = [put(d[k], SP) for k in ("p1", "p2")]
    st = [multihost.host_local_to_global(b, mesh, SP) for b in blocks]
    ok = (all(s.shape == torch.Size(d[k].shape) for s, k in zip(st, ("p1", "p2")))
          and all(torch.equal(multihost.global_to_host_local(s), b)
                  for s, b in zip(st, blocks))
          and all(torch.equal(s.full(), _t(d[k])) for s, k in zip(st, ("p1", "p2"))))
    out = ring_knn_points(st[0], st[1], _t(d["l1"]), _t(d["l2"]), K=4, mesh=mesh)
    ref = ring_knn_points(blocks[0], blocks[1], _t(d["l1"]), _t(d["l2"]), K=4,
                          mesh=mesh)
    return ok and torch.equal(out.idx, ref.idx) and torch.equal(out.dists, ref.dists)


def check_uneven_blocks(mesh):
    """Blocks of other sizes on one rank than on the others: every rank
    raises (none waits in a hop)."""
    P = 8 if mesh.rank == 0 else 6
    try:
        ring_knn_points(torch.zeros((1, P, 3)), torch.zeros((1, 8, 3)), K=2, mesh=mesh)
    except ValueError as e:
        return "sizes differ" in str(e)
    return False


def rank_main(rank: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize("file://" + os.path.join(out_dir, "init"),
                         num_processes=WORLD, process_id=rank)
    cpu = torch.device("cpu")
    meshes = {k: multihost.process_mesh(shape, names, device=cpu)
              for k, (shape, names) in MESHES.items()}
    puts = {k: process_put(m) for k, m in meshes.items()}
    results = {"coord": {k: m.coord for k, m in meshes.items()},
               "transport": {}}
    for name, (mesh_name, *_) in CASES.items():
        res = run_case(name, meshes[mesh_name], puts[mesh_name])
        results[name] = {k: (v.detach(), spec) for k, (v, spec) in res.items()}
    results["bit-equal"] = {k: (v.detach(), spec) for k, (v, spec) in
                            run_bit_equal(meshes["sp"], puts["sp"]).items()}
    results["host-local-to-global"] = check_host_local_to_global(
        meshes["sp"], puts["sp"])
    results["uneven-blocks-raise"] = check_uneven_blocks(meshes["sp"])
    from pytorch3d_pointops_tpu_torch.parallel.ring import _ProcessRing
    results["transport"] = _ProcessRing(meshes["sp"], "sp", None).transport
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(rank_main, args=(sys.argv[1],), nprocs=WORLD)
    print("OK")
