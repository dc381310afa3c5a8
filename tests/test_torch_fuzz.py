"""The port's seeded sweep (``pytorch3d_pointops_tpu_torch/sweep.py``) on the
CPU: each case through the port's plain path against the JAX package's
public ops on the same numpy inputs, with the tolerances ``chip_smoke.py``
phase 9 holds the kernels to (indices equal, values within 1e-5, gradients
within 1e-5 of their largest entry), and against the port's host library
where it has the op. One parametrised test per op family and block of
seeds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_pointops_tpu as jp
from pytorch3d_pointops_tpu.ops.fps import _fps_indices
from pytorch3d_pointops_tpu_torch import sweep

# The module, not the function of the same name that the package exports.
jax_sample_pdf = importlib.import_module("pytorch3d_pointops_tpu.ops.sample_pdf")
torch.set_num_threads(2)
CASES = sweep.cases(60)
BLOCK = 5
BLOCKS = sorted({(c.family, i // (BLOCK * len(sweep.FAMILIES))) for i, c in enumerate(CASES)})


def run_case_jax(case, port_out, monkeypatch):
    """The case through the JAX package's public ops, outputs named as
    ``sweep.run_case`` names them. Random FPS starts and PDF quantiles are
    the port's (the first index of each cloud; the CPU generator's draws).
    Each case is one ``jax.jit`` of its arrays, everything else a constant:
    one compile a case instead of one for each primitive."""
    x = sweep.inputs(case)
    p = case.p
    np_ = np.asarray
    if case.family == "knn":
        l1, l2 = x["lengths1"], x["lengths2"]

        def loss(a, b):
            r = jp.knn_points(a, b, l1, l2, norm=p["norm"], K=p["K"], return_nn=True)
            return (r.dists * x["g"]).sum(), r

        def both(a, b):
            uns = jp.knn_points(a, b, l1, l2, norm=p["norm"], K=p["K"], return_sorted=False)
            return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(a, b), uns

        ((_, res), (g1, g2)), uns = jax.jit(both)(x["p1"], x["p2"])
        return {"dists": np_(res.dists), "idx": np_(res.idx).astype(np.int64),
                "nn": np_(res.knn), "unsorted_dists": np_(uns.dists),
                "unsorted_idx": np_(uns.idx).astype(np.int64),
                "grad_p1": np_(g1), "grad_p2": np_(g2)}
    if case.family == "ball_query":
        def loss(a, b):
            r = jp.ball_query(a, b, x["lengths1"], x["lengths2"], K=p["K"],
                              radius=p["radius"])
            return (r.dists * x["g"]).sum(), r

        (_, res), (g1, g2) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            x["p1"], x["p2"])
        return {"dists": np_(res.dists), "idx": np_(res.idx).astype(np.int64),
                "nn": np_(res.knn), "grad_p1": np_(g1), "grad_p2": np_(g2)}
    if case.family == "fps":
        N = x["points"].shape[0]
        K = np.broadcast_to(np.asarray(x["K"], np.int64), (N,))
        max_K = int(K.max()) if K.size else 0
        starts = (np.maximum(port_out["idx"][:, 0], 0) if p["random_start"] and max_K
                  else np.zeros(N, np.int64))
        idx = jax.jit(lambda a: _fps_indices(a, jnp.asarray(x["lengths"]), jnp.asarray(K),
                                             jnp.asarray(starts), max_K, "xla"))(x["points"])
        idx = np_(idx).astype(np.int64)
        return {"idx": idx, "points": np_(jp.masked_gather(x["points"], idx))}
    if case.family == "chamfer":
        feats = bool(p["features"])

        def loss(a, b, fa, fb):
            loss, loss_f = jp.chamfer_distance(
                a, b, x["lengths1"], x["lengths2"],
                x_features={"normals": fa} if feats else None,
                y_features={"normals": fb} if feats else None,
                weights=x["weights"], batch_reduction=p["batch_reduction"],
                point_reduction=p["point_reduction"], norm=p["norm"],
                single_directional=p["single_directional"], abs_cosine=p["abs_cosine"],
                feature_names=["normals"] if feats else None,
            )
            leaves = sweep.chamfer_leaves(loss, loss_f)
            total = sum((t * sweep.chamfer_cotangent(case, i, t.shape)).sum()
                        for i, t in enumerate(leaves.values()))
            return total, leaves

        (_, leaves), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(*(x[k] for k in ("p1", "p2", "f1", "f2")))
        out = {k: np_(v) for k, v in leaves.items()}
        out.update(zip(("grad_x", "grad_y", "grad_fx", "grad_fy"), map(np_, grads)))
        return out
    if case.family == "gather":
        idx, first, F = x["idx"], x["first_idxs"], x["packed"].shape[0]
        M = int(x["max_size"])

        def everything(points, packed):
            gathered = jp.masked_gather(points, idx)
            g_points = jax.grad(lambda a: (jp.masked_gather(a, idx) * x["h"]).sum())(points)
            padded = jp.packed_to_padded(packed, first, M)
            g_packed = jax.grad(lambda a: (jp.packed_to_padded(a, first, M)
                                           * x["h_padded"]).sum())(packed)
            repacked = jp.padded_to_packed(padded, first, F)
            g_padded = jax.grad(lambda a: (jp.padded_to_packed(a, first, F)
                                           * x["h_packed"]).sum())(padded)
            return {"gathered": gathered, "grad_points": g_points, "padded": padded,
                    "grad_packed": g_packed, "repacked": repacked, "grad_padded": g_padded}

        return {k: np_(v) for k, v in jax.jit(everything)(x["points"], x["packed"]).items()}
    with monkeypatch.context() as m:
        if not p["det"]:
            u = torch.rand((p["B"], p["S"]), generator=torch.Generator().manual_seed(case.seed))
            m.setattr(jax_sample_pdf, "_uniform_quantiles",
                      lambda *a, **k: jnp.asarray(u.numpy()))
        out = jax.jit(lambda b, w: jp.sample_pdf(
            b, w, p["S"], det=p["det"], key=jax.random.PRNGKey(0)))(x["bins"], x["weights"])
    return {"samples": np_(out)}


@pytest.mark.parametrize("family,block", BLOCKS)
def test_sweep_plain_path_matches_jax(family, block, monkeypatch):
    span = BLOCK * len(sweep.FAMILIES)
    chosen = [c for c in CASES[block * span:(block + 1) * span] if c.family == family]
    assert chosen
    for case in chosen:
        out = sweep.run_case(case, "cpu")
        sweep.compare(case, out, run_case_jax(case, out, monkeypatch), "plain path vs JAX")
        sweep.check_native(case, out)


def test_sweep_cases_are_seeded_and_cover_every_family():
    again = sweep.cases(60)
    assert again == CASES
    assert {c.family for c in CASES} == set(sweep.FAMILIES)
    case = CASES[0]
    a, b = sweep.inputs(case), sweep.inputs(case)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # Every failure names its case.
    bad = sweep.run_case(case, "cpu")
    bad["idx"] = bad["idx"] + 1
    with pytest.raises(AssertionError, match=f"seed={case.seed}"):
        sweep.compare(case, bad, sweep.run_case(case, "cpu"))
