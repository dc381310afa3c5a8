"""The port's public ops on empty dimensions and K = 0 against the JAX
package, on the CPU: ``sweep.empty_cases()`` (N, P1, P2 or P = 0, K = 0, the
chamfer option matrix with an empty y cloud, every length 0 with P > 0),
the same numpy inputs through both packages. Where JAX returns: shapes
equal, indices equal, values within 1e-5 and gradients within 1e-5 of
their largest entry, NaN where NaN. Where JAX refuses (``expect ==
"raises"``), the port raises too; its ``get_bounding_boxes`` with the same
``ValueError``. Where JAX crashes in a reshape (N = 0 for KNN, ball query
and the grouped ``masked_gather``: integer modulo by zero), the port
returns empty outputs. One parametrised test per op family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_pointops_tpu as jp
from pytorch3d_pointops_tpu_torch import sweep

torch.set_num_threads(2)
CASES = sweep.empty_cases()


def _cases(*families):
    return [pytest.param(c, id=f"{c.family}-{c.seed}") for c in CASES
            if c.family in families]


def run_case_jax(case):
    """The case through the JAX package's public ops, eagerly, outputs named
    as ``sweep.run_case`` names them."""
    x = sweep.inputs(case)
    p = case.p
    np_ = np.asarray
    if case.family in ("knn", "ball_query"):
        l1, l2 = x["lengths1"], x["lengths2"]

        def call(a, b, **kw):
            if case.family == "knn":
                return jp.knn_points(a, b, l1, l2, norm=p["norm"], K=p["K"], **kw)
            return jp.ball_query(a, b, l1, l2, K=p["K"], radius=p["radius"])

        def loss(a, b):
            r = call(a, b, return_nn=True)
            return (r.dists * x["g"]).sum(), r

        (_, res), (g1, g2) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            x["p1"], x["p2"])
        out = {"dists": np_(res.dists), "idx": np_(res.idx).astype(np.int64),
               "nn": np_(res.knn), "grad_p1": np_(g1), "grad_p2": np_(g2)}
        if case.family == "knn":
            uns = call(x["p1"], x["p2"], return_sorted=False)
            out.update(unsorted_dists=np_(uns.dists),
                       unsorted_idx=np_(uns.idx).astype(np.int64))
        return out
    if case.family in ("fps", "fps_naive"):
        fps = (jp.sample_farthest_points if case.family == "fps"
               else jp.sample_farthest_points_naive)
        sel, idx = fps(x["points"], x["lengths"], K=x["K"])
        return {"idx": np_(idx).astype(np.int64), "points": np_(sel)}
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

        (_, leaves), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(x[k] for k in ("p1", "p2", "f1", "f2")))
        out = {k: np_(v) for k, v in leaves.items()}
        out.update(zip(("grad_x", "grad_y", "grad_fx", "grad_fy"), map(np_, grads)))
        return out
    if case.family in ("masked_gather", "knn_gather"):
        gather = (jp.masked_gather if case.family == "masked_gather"
                  else lambda v, i: jp.knn_gather(v, i))
        values = x["points" if case.family == "masked_gather" else "x"]
        gathered = gather(values, x["idx"])
        grad = jax.grad(lambda v: (gather(v, x["idx"]) * x["h"]).sum())(values)
        return {"gathered": np_(gathered), "grad": np_(grad)}
    if case.family == "covariances":
        def loss(a):
            cov, nn = jp.get_point_covariances(a, x["lengths"], p["K"])
            return (cov * x["h"]).sum() + (nn * x["h_nn"]).sum(), (cov, nn)

        (_, (cov, nn)), grad = jax.value_and_grad(loss, has_aux=True)(x["points"])
        return {"cov": np_(cov), "nn": np_(nn), "grad": np_(grad)}
    assert case.family == "bounding_boxes"
    clouds = jp.Pointclouds([jnp.asarray(x["points"][n, :length])
                             for n, length in enumerate(x["lengths"])])
    return {"boxes": np_(jp.get_bounding_boxes(clouds))}


def check(case):
    if case.expect == "returns":
        sweep.compare(case, sweep.run_case(case, "cpu"), run_case_jax(case),
                      "port vs JAX")
        return
    with pytest.raises(Exception) as jax_error:
        run_case_jax(case)
    if case.expect == "crashes":
        # JAX's integer modulo by zero is no refusal: the port returns its
        # empty outputs.
        assert jax_error.type is ZeroDivisionError, jax_error.value
        out = sweep.run_case(case, "cpu")
        assert all(v.size == 0 for v in out.values()), {k: v.shape for k, v in out.items()}
        return
    with pytest.raises(jax_error.type if case.family == "bounding_boxes" else Exception,
                       match=(str(jax_error.value) if case.family == "bounding_boxes"
                              else None)):
        sweep.run_case(case, "cpu")


@pytest.mark.parametrize("case", _cases("knn"))
def test_knn_points_empty(case):
    check(case)


@pytest.mark.parametrize("case", _cases("ball_query"))
def test_ball_query_empty(case):
    check(case)


@pytest.mark.parametrize("case", _cases("chamfer"))
def test_chamfer_distance_empty(case):
    check(case)


@pytest.mark.parametrize("case", _cases("fps", "fps_naive"))
def test_sample_farthest_points_empty(case):
    check(case)


@pytest.mark.parametrize("case", _cases("masked_gather", "knn_gather"))
def test_gathers_empty(case):
    check(case)


@pytest.mark.parametrize("case", _cases("covariances"))
def test_point_covariances_empty(case):
    check(case)


@pytest.mark.parametrize("case", _cases("bounding_boxes"))
def test_bounding_boxes_every_cloud_empty(case):
    check(case)


def test_empty_cases_cover_the_listed_inputs():
    """Every family, each of N, P1, P2, P and K at 0, every chamfer
    reduction with an empty y cloud (bidirectional and single, with and
    without features, each weighting), and every length 0 with P > 0."""
    assert {c.family for c in CASES} == {
        "knn", "ball_query", "chamfer", "fps", "fps_naive", "masked_gather",
        "knn_gather", "covariances", "bounding_boxes"}
    for key in ("N", "P1", "P2", "P", "K", "M"):
        assert any(c.p.get(key) == 0 for c in CASES), key
    empty_y = [c.p for c in CASES if c.family == "chamfer" and c.p["P2"] == 0 and c.p["N"]]
    assert {(p["point_reduction"], p["batch_reduction"], p["single_directional"],
             p["weights"]) for p in empty_y} == {
        (pr, br, s, w) for pr, br in sweep.CHAMFER_REDUCTIONS for s in (False, True)
        for w in ("none", "random", "zero")}
    assert {p["norm"] for p in empty_y} == {1, 2}
    assert any(p["features"] for p in empty_y)
    assert any(c.p.get("lengths") == "zero" and min(c.p.get("P", 1), c.p.get("P2", 1)) > 0
               for c in CASES)
    assert sweep.empty_cases() == CASES
