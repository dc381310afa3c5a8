"""The port's ring across processes (``multihost.process_mesh``) on the CPU:
four gloo ranks, one position of the ring each, every hop a send and a
receive between neighbouring ranks, the chamfer's sums taken across ranks.

One subprocess spawns the four ranks once for the module
(``ring_procs_cases.py``); each runs every case on its own blocks and saves
its output blocks, gradient blocks and losses. Each parametrised case puts
the blocks back together and holds them against JAX's ring on four of the
eight virtual CPU devices (indices equal, values within 1e-5, gradients
within 1e-5 of their largest entry) and against the port's one-process ring
on four shards of the CPU (indices and distances equal, losses within 1e-5,
gradients within 1e-5 of their largest entry). A reduced loss must be the
same on every rank. The JAX calls stay few and small: XLA's in-process CPU
collectives abort a rendezvous that waits 40 s."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.parallel import make_mesh as jax_make_mesh
from pytorch3d_pointops_tpu.parallel import ring_chamfer_distance as jax_ring_chamfer
from pytorch3d_pointops_tpu.parallel import ring_knn_gather as jax_ring_gather
from pytorch3d_pointops_tpu.parallel import ring_knn_points as jax_ring_knn
from pytorch3d_pointops_tpu_torch.parallel import make_mesh

import ring_procs_cases as rc

torch.set_num_threads(2)
TOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved results, from one spawn of four gloo ranks."""
    out = tmp_path_factory.mktemp("ring_procs")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # gloo on the CPU, on any machine
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "ring_procs_cases.py"), str(out)],
        capture_output=True, text=True, timeout=180, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(rc.WORLD)]


def _assemble(ranks, case, mesh_name):
    """Each output of ``case`` put back together from the ranks' blocks;
    a replicated value must be equal on every rank."""
    shape, names = rc.MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    out = {}
    for key, (first, spec) in ranks[0][case].items():
        blocks = [res[case][key][0] for res in ranks]
        if spec is None:
            for b in blocks[1:]:
                assert torch.equal(b, first), (case, key, "differs between ranks")
            out[key] = first
            continue
        whole = torch.empty([s * (sizes[n] if n else 1)
                             for s, n in zip(first.shape, spec)], dtype=first.dtype)
        for res, b in zip(ranks, blocks):
            coord = dict(zip(names, res["coord"][mesh_name]))
            whole[tuple(slice(coord[n] * s, (coord[n] + 1) * s) if n else slice(None)
                        for s, n in zip(b.shape, spec))] = b
        out[key] = whole
    return out


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _check_grad(ref, out, what):
    """Within TOL of the reference's largest entry."""
    ref = _np(ref)
    err = np.abs(_np(out) - ref).max()
    assert err <= TOL * np.abs(ref).max(), (what, err, np.abs(ref).max())


# ----------------------------- JAX's ring -----------------------------

def _jax_mesh(mesh_name):
    shape, names = rc.MESHES[mesh_name]
    return jax_make_mesh(shape, names, devices=jax.devices()[:rc.WORLD])


def jax_knn(d, jmesh, K, norm, batch_axis=None, spec=None):
    def f(a, b):
        o = jax_ring_knn(a, b, d["l1"], d["l2"], K=K, norm=norm, mesh=jmesh,
                         batch_axis=batch_axis, return_nn=True)
        loss = (o.dists * d["w"]).sum() + (o.knn * d["wn"]).sum()
        return loss, dict(dists=o.dists, idx=o.idx, knn=o.knn)

    (_, out), (g1, g2) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        d["p1"], d["p2"])
    return dict(out, grad_p1=g1, grad_p2=g2)


def jax_gather(d, jmesh):
    def f(v):
        out = jax_ring_gather(v, jnp.asarray(d["idx"], jnp.int32), d["lengths"],
                              mesh=jmesh)
        return (out * d["w"]).sum(), out

    (_, out), g = jax.jit(jax.value_and_grad(f, has_aux=True))(d["x"])
    return dict(gathered=out, grad_x=g)


def jax_chamfer(d, jmesh, features=False, batch_axis=None, spec=None, **kw):
    if "weights" in kw:
        kw["weights"] = np.asarray(kw["weights"], np.float32)
    keys = ("x", "y", "xn", "xc", "yn", "yc") if features else ("x", "y")

    def f(*args):
        a = dict(zip(keys, args))
        extra = {}
        if features:
            extra = dict(x_features={"normals": a["xn"], "colors": a["xc"]},
                         y_features={"normals": a["yn"], "colors": a["yc"]},
                         feature_names=["normals", "colors"])
        out = jax_ring_chamfer(a["x"], a["y"], d["lx"], d["ly"], mesh=jmesh,
                               batch_axis=batch_axis, **extra, **kw)
        loss, lf = out if features else (out, None)
        if kw.get("point_reduction", "mean") is None:
            cx, cy = loss if isinstance(loss, tuple) else (loss, None)
            total, aux = (cx * d["wx"]).sum(), {"terms_x": cx}
            if cy is not None:
                total, aux["terms_y"] = total + (cy * d["wy"]).sum(), cy
            return total, aux
        total = loss + (lf["normals"] + lf["colors"] if features else 0.0)
        return total.sum(), {"loss": total.reshape(-1)}

    (_, out), grads = jax.jit(jax.value_and_grad(f, tuple(range(len(keys))),
                                                 has_aux=True))(*(d[k] for k in keys))
    return dict(out, **{f"grad_{k}": g for k, g in zip(keys, grads)})


JAX_RUNS = {"knn": jax_knn, "gather": jax_gather, "chamfer": jax_chamfer}


# ----------------------------- the cases -----------------------------

@pytest.mark.parametrize("case", list(rc.CASES))
def test_ring_across_processes(ranks, case):
    """The four ranks' blocks against JAX's ring and the port's
    one-process ring on the same inputs."""
    mesh_name, inputs, kind, kw = rc.CASES[case]
    out = _assemble(ranks, case, mesh_name)
    d = inputs()

    ref = JAX_RUNS[kind](d, _jax_mesh(mesh_name), **kw)
    assert set(ref) == set(out), (sorted(ref), sorted(out))
    for key, r in ref.items():
        if key == "idx":
            np.testing.assert_array_equal(_np(out[key]), _np(r))
        elif key.startswith("grad"):
            _check_grad(r, out[key], (case, key, "vs JAX"))
        else:
            np.testing.assert_allclose(_np(out[key]), _np(r), rtol=TOL, atol=TOL,
                                       err_msg=f"{case} {key} vs JAX")

    shape, names = rc.MESHES[mesh_name]
    local = make_mesh(shape, names, devices=[torch.device("cpu")] * rc.WORLD)
    one = rc.RUNS[kind](d, local, lambda a, spec: torch.as_tensor(np.asarray(a)), **kw)
    for key, (r, _) in one.items():
        if key in ("idx", "dists"):
            assert torch.equal(out[key], r), (case, key, "vs the one-process ring")
        elif key.startswith("grad"):
            _check_grad(r, out[key], (case, key, "vs the one-process ring"))
        else:
            np.testing.assert_allclose(_np(out[key]), _np(r), rtol=TOL, atol=TOL,
                                       err_msg=f"{case} {key} vs the one-process ring")


def test_tied_maximum_splits_across_ranks(ranks):
    """The Hausdorff case's maximum is tied between rank 0's and rank 2's
    blocks: each of the two rows gets half the gradient, not all of it."""
    d = rc.tied_max_inputs()
    g = _assemble(ranks, "chamfer-max-tied-across-ranks", "sp")["grad_x"]
    # The batch mean halves each cloud's maximum and the tie halves it
    # again; the distance is |x - y|^2, so its gradient is 2 (x - y).
    for n in range(2):
        for row in (2, 26):
            x = d["x"][n, row]
            y = d["y"][n, np.argmin(((x - d["y"][n]) ** 2).sum(-1))]
            np.testing.assert_allclose(_np(g[n, row]), 0.25 * 2.0 * (x - y),
                                       rtol=1e-5, atol=1e-6)


def test_gradients_bit_equal_across_runs(ranks):
    """Two backward runs of ring KNN and of the ring chamfer with features
    across the processes give the same gradients bit for bit."""
    out = _assemble(ranks, "bit-equal", "sp")
    keys = [k[:-len("_run0")] for k in out if k.endswith("_run0")]
    assert len(keys) == 8, keys
    for k in keys:
        assert torch.equal(out[f"{k}_run0"], out[f"{k}_run1"]), k


def test_host_local_to_global_keeps_blocks(ranks):
    """On a process mesh ``host_local_to_global`` holds the block with the
    global shape, ``global_to_host_local`` gives it back, ``full()`` gathers
    the whole tensor, and the ring takes the result as it takes the blocks;
    gloo on CPU blocks sends them unstaged."""
    for res in ranks:
        assert res["host-local-to-global"] is True
        assert res["transport"] == "gloo"


def test_uneven_blocks_raise_on_every_rank(ranks):
    """A rank whose blocks differ in size from the others': the ring's
    size check raises ValueError on every rank, before any hop."""
    assert all(res["uneven-blocks-raise"] is True for res in ranks)
