"""The PyTorch port's chamfer_distance and its bidirectional nearest-neighbour
kernel module against the JAX package, on the CPU: the same numpy inputs go
through both, and losses and gradients agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu import Pointclouds as JaxPointclouds
from pytorch3d_pointops_tpu.kernels.chamfer_pallas import (
    chamfer_nn_bidirectional_pallas,
)
from pytorch3d_pointops_tpu.ops.chamfer import chamfer_distance as jax_chamfer
from pytorch3d_pointops_tpu.ops.knn import knn_backward as jax_knn_backward
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
from pytorch3d_pointops_tpu_torch.ops.chamfer import _k1_backward

torch.set_num_threads(2)
TOL = 1e-5


def _clouds(seed, N=2, P1=24, P2=36, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        x = rng.integers(-2, 3, size=(N, P1, 3)).astype(np.float32) / 8
        y = rng.integers(-2, 3, size=(N, P2, 3)).astype(np.float32) / 8
    else:
        x = rng.normal(size=(N, P1, 3)).astype(np.float32)
        y = rng.normal(size=(N, P2, 3)).astype(np.float32)
    l1 = np.array([P1, P1 - 7][:N])
    l2 = np.array([P2 - 11, P2][:N])
    return x, y, l1, l2


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _flat(out):
    """Every tensor in a (loss, features) result, in a fixed order."""
    loss, feats = out
    parts = list(loss) if isinstance(loss, tuple) else [loss]
    for k in sorted(feats or {}):
        v = feats[k]
        parts += [p for p in (v if isinstance(v, tuple) else (v,)) if p is not None]
    return parts


def _compare(jax_out, torch_out):
    a, b = _flat(jax_out), _flat(torch_out)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(
            v.detach().numpy(), np.asarray(u), rtol=TOL, atol=TOL
        )


REDUCTIONS = [
    ("mean", "mean"), ("mean", "sum"), ("mean", None),
    ("sum", "mean"), ("sum", "sum"), ("sum", None),
    ("max", "mean"), ("max", "sum"), ("max", None),
    (None, None),
]


@pytest.mark.parametrize("point_reduction,batch_reduction", REDUCTIONS)
@pytest.mark.parametrize("single_directional", [False, True])
def test_chamfer_reductions_match_jax(point_reduction, batch_reduction,
                                      single_directional):
    x, y, l1, l2 = _clouds(1)
    norm = 1 if point_reduction == "sum" else 2
    kw = dict(point_reduction=point_reduction, batch_reduction=batch_reduction,
              norm=norm, single_directional=single_directional)
    ref = jax_chamfer(x, y, l1, l2, impl="xla", **kw)
    out = ppt.chamfer_distance(_t(x), _t(y), _t(l1), _t(l2), **kw)
    _compare(ref, out)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("single_directional", [False, True])
def test_chamfer_gradients_match_jax(norm, single_directional):
    x, y, l1, l2 = _clouds(2 + norm, grid=norm == 1)

    def jloss(a, b):
        return jax_chamfer(a, b, l1, l2, norm=norm,
                           single_directional=single_directional, impl="xla")[0]

    gx, gy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, requires_grad=True), _t(y, requires_grad=True)
    loss, _ = ppt.chamfer_distance(tx, ty, _t(l1), _t(l2), norm=norm,
                                   single_directional=single_directional)
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weights", [[0.5, 2.0], [0.0, 0.0]])
@pytest.mark.parametrize("point_reduction", ["mean", None])
def test_chamfer_weights_match_jax(weights, point_reduction):
    x, y, l1, l2 = _clouds(4)
    w = np.asarray(weights, np.float32)
    batch = "mean" if point_reduction else None
    ref = jax_chamfer(x, y, l1, l2, weights=w, point_reduction=point_reduction,
                      batch_reduction=batch, impl="xla")
    tx = _t(x, requires_grad=True)
    out = ppt.chamfer_distance(tx, _t(y), _t(l1), _t(l2), weights=_t(w),
                               point_reduction=point_reduction,
                               batch_reduction=batch)
    _compare(ref, out)
    loss = out[0] if point_reduction else out[0][0]
    loss.sum().backward()
    assert tx.grad is not None
    with pytest.raises(ValueError):
        ppt.chamfer_distance(_t(x), _t(y), weights=_t(np.array([-1.0, 1.0])))


@pytest.mark.parametrize("abs_cosine", [True, False])
@pytest.mark.parametrize("point_reduction", ["mean", "sum", None])
def test_chamfer_features_match_jax(abs_cosine, point_reduction):
    x, y, l1, l2 = _clouds(5)
    rng = np.random.default_rng(6)
    fx = {"normals": rng.normal(size=(2, 24, 3)).astype(np.float32),
          "colors": rng.uniform(size=(2, 24, 3)).astype(np.float32)}
    fy = {"normals": rng.normal(size=(2, 36, 3)).astype(np.float32),
          "colors": rng.uniform(size=(2, 36, 3)).astype(np.float32)}
    fy["normals"][0, 3] = 0.0  # a zero normal: the clamp on |a|*|b| matters
    names = ["normals", "colors"]
    batch = "mean" if point_reduction else None
    ref = jax_chamfer(x, y, l1, l2, fx, fy, point_reduction=point_reduction,
                      batch_reduction=batch, abs_cosine=abs_cosine,
                      feature_names=names, impl="xla")
    out = ppt.chamfer_distance(
        _t(x), _t(y), _t(l1), _t(l2),
        {k: _t(v) for k, v in fx.items()}, {k: _t(v) for k, v in fy.items()},
        point_reduction=point_reduction, batch_reduction=batch,
        abs_cosine=abs_cosine, feature_names=names,
    )
    _compare(ref, out)


def test_chamfer_pointclouds_input_with_features():
    """The slice as a whole: Pointclouds carried over from the JAX package
    with the conversion helper, the loss and its gradient."""
    x, y, l1, l2 = _clouds(7, grid=True)
    rng = np.random.default_rng(8)
    fx = {"normals": rng.normal(size=(2, 24, 3)).astype(np.float32)}
    fy = {"normals": rng.normal(size=(2, 36, 3)).astype(np.float32)}
    jx = JaxPointclouds(jnp.asarray(x), features=fx, lengths=l1)
    jy = JaxPointclouds(jnp.asarray(y), features=fy, lengths=l2)
    ref = jax_chamfer(jx, jy, feature_names=["normals"], impl="xla")
    gref = jax.grad(lambda p: jax_chamfer(
        jx.update_padded(p), jy, feature_names=["normals"], impl="xla")[0]
    )(jnp.asarray(x))

    tx = ppt.pointclouds_from_numpy(
        np.asarray(jx.points_padded()), np.asarray(jx.num_points_per_cloud()),
        {k: np.asarray(v) for k, v in jx.features_padded().items()}, device="cpu",
    )
    ty = ppt.pointclouds_from_numpy(
        np.asarray(jy.points_padded()), np.asarray(jy.num_points_per_cloud()),
        {k: np.asarray(v) for k, v in jy.features_padded().items()}, device="cpu",
    )
    p = tx.points_padded().clone().requires_grad_(True)
    out = ppt.chamfer_distance(tx.update_padded(p), ty, feature_names=["normals"])
    _compare(ref, out)
    out[0].backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("norm", [1, 2])
def test_nn_plain_twin_matches_pallas_kernel(norm):
    """The kernel module's plain twin against the TPU kernel in interpret
    mode: both directions, lowest index on the grid's ties, and (inf, 0) for
    a fully masked side."""
    x, y, _, _ = _clouds(9, N=3, P1=20, P2=40, grid=True)
    l1, l2 = np.array([20, 13, 0]), np.array([0, 29, 40])
    ref = chamfer_nn_bidirectional_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(l1), jnp.asarray(l2), norm,
        tile_p1=16, tile_p2=128, interpret=True,
    )
    out = kc.chamfer_nn_bidirectional(_t(x), _t(y), _t(l1), _t(l2), norm)
    for side, (lx, P) in ((0, (l1, 20)), (2, (l2, 40))):
        other = l2 if side == 0 else l1
        for n in range(3):
            rows = slice(0, int(lx[n])) if other[n] > 0 else slice(0, 0)
            np.testing.assert_allclose(
                out[side].numpy()[n, rows], np.asarray(ref[side])[n, rows], atol=TOL
            )
            np.testing.assert_array_equal(
                out[side + 1].numpy()[n, rows], np.asarray(ref[side + 1])[n, rows]
            )
    assert np.isinf(out[0].numpy()[0]).all() and (out[1].numpy()[0] == 0).all()
    assert np.isinf(out[2].numpy()[2]).all() and (out[3].numpy()[2] == 0).all()


def test_k1_backward_matches_knn_backward():
    """The K=1 backward with the segment-sum against the JAX package's
    general KNN backward (both norms, ragged lengths, -1 pads)."""
    x, y, l1, l2 = _clouds(10, P1=40, P2=30)
    rng = np.random.default_rng(1)
    idx = rng.integers(-1, 30, size=(2, 40))
    g = rng.normal(size=(2, 40)).astype(np.float32)
    for norm in (1, 2):
        gx, gy = _k1_backward(_t(x), _t(y), _t(l1), _t(l2), _t(idx).clamp(min=0),
                              norm, _t(g))
        rx, ry = jax_knn_backward(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(l1), jnp.asarray(l2),
            jnp.asarray(np.maximum(idx, 0)[..., None].astype(np.int32)), norm,
            jnp.asarray(g[..., None]),
        )
        np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=TOL)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=TOL)


def test_chamfer_input_errors():
    x = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError):
        ppt.chamfer_distance(x, x, point_reduction="median")
    with pytest.raises(ValueError):
        ppt.chamfer_distance(x, x, point_reduction=None, batch_reduction="mean")
    with pytest.raises(ValueError):
        ppt.chamfer_distance(x, x, norm=3)
    with pytest.raises(ValueError):
        ppt.chamfer_distance(x, x, point_reduction="max", feature_names=["n"])
    with pytest.raises(ValueError):
        ppt.chamfer_distance(x[0], x)
    with pytest.raises(ValueError):
        kc.chamfer_nn_bidirectional(
            x.to("meta"), x.to("meta"), torch.zeros(2, dtype=torch.int64, device="meta"),
            torch.zeros(2, dtype=torch.int64, device="meta"), 2,
        )
