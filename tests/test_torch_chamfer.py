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
from pytorch3d_pointops_tpu_torch.kernels.knn import pairwise_dist
from pytorch3d_pointops_tpu_torch.ops.chamfer import _k1_backward

torch.set_num_threads(2)
TOL = 1e-5
_INF_F = float("inf")


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


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("single_directional", [False, True])
def test_chamfer_max_gradients_match_jax(norm, single_directional):
    """The ``point_reduction="max"`` rows of the gradient check: grid
    points at norm 1, where maxima tie."""
    x, y, l1, l2 = _clouds(2 + norm, grid=norm == 1)
    kw = dict(norm=norm, single_directional=single_directional,
              point_reduction="max")

    def jloss(a, b):
        return jax_chamfer(a, b, l1, l2, impl="xla", **kw)[0]

    gx, gy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, requires_grad=True), _t(y, requires_grad=True)
    loss, _ = ppt.chamfer_distance(tx, ty, _t(l1), _t(l2), **kw)
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("single_directional", [False, True])
def test_chamfer_tied_max_gradient_matches_jax(single_directional):
    """Four points at x = 0, 1, 3, 4 against 0.5 and 3.5, norm 1: every
    point's nearest distance is 0.5, so the maximum ties four ways (two in
    the other direction) and its gradient is split evenly among them, as
    ``jnp.max`` splits it: d/dx [-0.25, 0.25, -0.25, 0.25] one-way."""
    x = np.zeros((1, 4, 3), np.float32)
    y = np.zeros((1, 2, 3), np.float32)
    x[0, :, 0] = [0, 1, 3, 4]
    y[0, :, 0] = [0.5, 3.5]
    kw = dict(norm=1, point_reduction="max", single_directional=single_directional)

    def jloss(a, b):
        return jax_chamfer(a, b, impl="xla", **kw)[0]

    gx, gy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, requires_grad=True), _t(y, requires_grad=True)
    loss, _ = ppt.chamfer_distance(tx, ty, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), 0.5, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=TOL, atol=TOL)
    want = [-0.25, 0.25, -0.25, 0.25] if single_directional else [-0.375, 0.125,
                                                                  -0.375, 0.125]
    np.testing.assert_allclose(tx.grad.numpy()[0, :, 0], want, rtol=TOL, atol=TOL)


def test_chamfer_gather_fn_hook():
    """``_chamfer_distance_single_direction(gather_fn=)``, JAX's hook for
    the neighbour-feature gather: a custom gather that calls ``knn_gather``
    gives the default's loss, features and gradients."""
    from pytorch3d_pointops_tpu_torch.ops import chamfer as oc
    from pytorch3d_pointops_tpu_torch.ops.knn import knn_gather

    x, y, l1, l2 = _clouds(12)
    rng = np.random.default_rng(13)
    fx = {"n": _t(rng.normal(size=(2, 24, 3)).astype(np.float32))}
    fy = {"n": _t(rng.normal(size=(2, 36, 3)).astype(np.float32))}
    calls = []

    def gather(v, idx, lengths):
        calls.append(idx.shape)
        return knn_gather(v, idx, lengths)

    outs = []
    for fn in (None, gather):
        tx = _t(x, requires_grad=True)
        out = oc._chamfer_distance_single_direction(
            tx, _t(y), _t(l1), _t(l2), fx, fy, None, "mean", 2, True, ["n"],
            gather_fn=fn)
        (out[0].sum() + out[1]["n"].sum()).backward()
        outs.append((out[0], out[1]["n"], tx.grad))
    assert calls == [(2, 24, 1)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


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
    """The slice as a whole: Pointclouds brought over from the JAX package
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


def _dup_cloud(rng, N, P):
    """Gaussian points where a tenth of each cloud copies other points."""
    a = rng.normal(size=(N, P, 3)).astype(np.float32)
    k = max(P // 10, 1)
    for n in range(N):
        a[n, rng.choice(P, size=k, replace=False)] = a[n, rng.integers(0, P, size=k)]
    return a


# (seed, P1, P2, lengths1, lengths2, grid, norm): lengths of 0, 1 and P - 1,
# grid clouds full of exact ties, clouds with duplicated points, and sizes
# that are no multiple of 16 (the TPU kernel's x tile) or of 128 (its y
# tile). The first two cases, one per norm, keep the ids "1" and "2".
NN_SWEEP = [
    pytest.param(9, 20, 40, [20, 13, 0], [0, 29, 40], True, 1, id="1"),
    pytest.param(9, 20, 40, [20, 13, 0], [0, 29, 40], True, 2, id="2"),
    (11, 20, 37, [0, 20, 5], [37, 0, 36], True, 2),
    (12, 21, 40, [1, 21, 20], [40, 1, 1], False, 1),
    (13, 33, 47, [32, 33, 1], [46, 47, 0], True, 1),
    (14, 40, 130, [40, 29, 39], [130, 77, 129], True, 2),
    (15, 17, 129, [17, 9, 16], [128, 129, 2], False, 2),
    (16, 17, 129, [16, 17, 0], [129, 1, 128], True, 1),
    (17, 50, 61, [50, 49, 1], [61, 60, 30], False, 1),
    (18, 45, 200, [44, 45, 45], [199, 200, 0], False, 2),
]


@pytest.mark.parametrize("seed,P1,P2,l1,l2,grid,norm", NN_SWEEP)
def test_nn_plain_twin_matches_pallas_kernel(seed, P1, P2, l1, l2, grid, norm):
    """The kernel module's plain twin against the TPU kernel in interpret
    mode, a seeded sweep over every point of every cloud, padded and empty
    ones included: both directions, distances within TOL (inf where the
    kernel gives inf), indices equal (the lowest on ties), and (inf, 0)
    where a point has no valid partner or lies past its length."""
    rng = np.random.default_rng(seed)
    if grid:
        x = rng.integers(-2, 3, size=(3, P1, 3)).astype(np.float32) / 8
        y = rng.integers(-2, 3, size=(3, P2, 3)).astype(np.float32) / 8
    else:
        x, y = _dup_cloud(rng, 3, P1), _dup_cloud(rng, 3, P2)
    l1, l2 = np.array(l1), np.array(l2)
    ref = chamfer_nn_bidirectional_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(l1), jnp.asarray(l2), norm,
        tile_p1=16, tile_p2=128, interpret=True,
    )
    out = kc.chamfer_nn_bidirectional(_t(x), _t(y), _t(l1), _t(l2), norm)
    for side in (0, 2):
        np.testing.assert_allclose(out[side].numpy(), np.asarray(ref[side]), atol=TOL)
        np.testing.assert_array_equal(out[side + 1].numpy(), np.asarray(ref[side + 1]))
    for side, lx, ly in ((0, l1, l2), (2, l2, l1)):
        P = out[side].shape[1]
        dead = (np.arange(P)[None] >= lx[:, None]) | (ly[:, None] == 0)
        assert np.isinf(out[side].numpy()[dead]).all()
        assert (out[side + 1].numpy()[dead] == 0).all()


_BLOCK = 1024  # the kernel's x and y chunk
_SUB = 128  # its sub-tile
_INIT_KEY = 0x7F800000 << 32  # (inf, 0)


def _block_keys(d, first):
    """(value, sub-tile) keys of each row of one block's distance tile ``d``
    whose columns start at point ``first``: the row's minimum value alone,
    then the lowest 128-point sub-tile that holds it, numbered within the
    cloud; (inf, 0) where the minimum is inf."""
    R, C = d.shape
    sub_min = torch.nn.functional.pad(d, (0, -C % _SUB), value=_INF_F)
    sub_min = sub_min.view(R, -1, _SUB).amin(dim=2)
    v = sub_min.amin(dim=1)
    s = (sub_min == v[:, None]).int().argmax(dim=1) + first // _SUB
    key = (v.view(torch.int32).to(torch.int64) << 32) | s
    return torch.where(v < _INF_F, key, _INIT_KEY)


def _rescan(key, q, c, lengths_c, norm):
    """Each point's key's sub-tile of the other side, scanned again with the
    plain twin's arithmetic: the key's value and the first index there whose
    distance equals it bit for bit; (inf, 0) for a key of (inf, 0)."""
    N, P = key.shape
    dist = (key >> 32).to(torch.int32).view(torch.float32).clone()
    idx = torch.zeros((N, P), dtype=torch.int64)
    live = key != _INIT_KEY
    n, i = live.nonzero(as_tuple=True)
    if n.numel():
        j = (key[n, i] & 0xFFFFFFFF)[:, None] * _SUB + torch.arange(_SUB)
        valid = j < lengths_c.clamp(0, c.shape[1])[n][:, None]
        cand = c[n[:, None], j.clamp(max=c.shape[1] - 1)]
        d = torch.zeros(j.shape)
        for a in range(q.shape[2]):
            diff = q[n, i, a][:, None] - cand[..., a]
            d = d + (diff * diff if norm == 2 else diff.abs())
        hit = valid & (d == dist[n, i][:, None])
        assert hit.any(dim=1).all()
        idx[n, i] = j.gather(1, hit.int().argmax(dim=1, keepdim=True))[:, 0]
    return dist, idx


def _two_pass_nn(x, y, lengths1, lengths2, norm):
    """A plain model of the CUDA kernel's D = 3 design: value-only minima per
    1,024 x 1,024 block, merged across blocks as (value, sub-tile) keys, then
    each index found by the first-equal rescan of that one sub-tile."""
    N, P1, _ = x.shape
    P2 = y.shape[1]
    key_x = torch.full((N, P1), _INIT_KEY, dtype=torch.int64)
    key_y = torch.full((N, P2), _INIT_KEY, dtype=torch.int64)
    for n in range(N):
        n1, n2 = int(lengths1[n].clamp(0, P1)), int(lengths2[n].clamp(0, P2))
        for a in range(0, n1, _BLOCK):
            for b in range(0, n2, _BLOCK):
                d = pairwise_dist(x[n, a:min(a + _BLOCK, n1)], y[n, b:min(b + _BLOCK, n2)],
                                  norm)
                kx, ky = key_x[n, a:a + d.shape[0]], key_y[n, b:b + d.shape[1]]
                kx.copy_(torch.minimum(kx, _block_keys(d, b)))
                ky.copy_(torch.minimum(ky, _block_keys(d.T, a)))
    return (*_rescan(key_x, x, y, lengths2, norm), *_rescan(key_y, y, x, lengths1, norm))


def _model_clouds(kind, rng, N, P1, P2):
    if kind == "grid":  # 125 positions: exact ties across sub-tiles and blocks
        return (rng.integers(-2, 3, size=(N, P1, 3)).astype(np.float32) / 8,
                rng.integers(-2, 3, size=(N, P2, 3)).astype(np.float32) / 8)
    x = rng.normal(size=(N, P1, 3)).astype(np.float32)
    y = rng.normal(size=(N, P2, 3)).astype(np.float32)
    if kind == "overflow":  # every distance of these points overflows to inf
        x[:, ::97] = 3e38
        y[:, 5::89] = -3e38
    return x, y


# (lengths1, lengths2) per cloud: ragged, no multiple of 128 or 1,024, one
# cloud's side of length 0.
MODEL_LENGTHS = {"ragged": ([1100, 1029], [2300, 1153]),
                 "empty_side": ([1100, 0], [2300, 2277])}


@pytest.mark.parametrize("lengths", sorted(MODEL_LENGTHS))
@pytest.mark.parametrize("kind", ["gauss", "grid", "overflow"])
@pytest.mark.parametrize("norm", [1, 2])
def test_two_pass_model_equals_plain_twin(norm, kind, lengths):
    """The D = 3 kernel's scheme, modelled plainly, bit for bit against
    ``chamfer_nn_plain`` in both directions: distances and indices, ties
    resolved to the lowest index across sub-tiles and blocks, (inf, 0) where
    a point has no partner or every distance overflows."""
    rng = np.random.default_rng([norm, len(kind), len(lengths)])
    x, y = map(_t, _model_clouds(kind, rng, 2, 1100, 2300))
    l1, l2 = (_t(np.array(v)) for v in MODEL_LENGTHS[lengths])
    want = kc.chamfer_nn_plain(x, y, l1, l2, norm)
    got = _two_pass_nn(x, y, l1, l2, norm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if kind == "grid":  # rows of the first cloud whose minimum ties across
        # sub-tiles of a block, and across blocks
        tie = pairwise_dist(x[0], y[0], norm) == want[0][0, :, None]
        assert (tie[:, :_SUB].any(dim=1) & tie[:, _SUB:_BLOCK].any(dim=1)).any()
        assert (tie[:, :_BLOCK].any(dim=1) & tie[:, _BLOCK:].any(dim=1)).any()
    if kind == "overflow":
        assert torch.isinf(want[0][0, ::97]).all() and (want[1][0, ::97] == 0).all()


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


@pytest.mark.parametrize("point_reduction,batch_reduction",
                         [("mean", "mean"), ("sum", None), (None, None)])
def test_chamfer_empty_y_with_weights_and_features(point_reduction, batch_reduction):
    """y with no point (x (2, 5, 3), y (2, 0, 3)) under weights [1, 2] and a
    feature channel: losses, feature losses and every gradient as JAX gives
    them. It used to raise in the nearest-neighbour twin's ``min`` over an
    empty tile."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    y = np.zeros((2, 0, 3), np.float32)
    fx = rng.normal(size=(2, 5, 2)).astype(np.float32)
    fy = np.zeros((2, 0, 2), np.float32)
    w = np.array([1.0, 2.0], np.float32)
    kw = dict(weights=w, point_reduction=point_reduction, batch_reduction=batch_reduction,
              feature_names=["n"])

    def jtotal(a, b, fa, fb):
        parts = _flat(jax_chamfer(a, b, x_features={"n": fa}, y_features={"n": fb}, **kw))
        return sum(jnp.sum(p * (i + 1)) for i, p in enumerate(parts)), parts

    (_, jparts), jgrads = jax.value_and_grad(jtotal, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, y, fx, fy)))
    ts = [_t(a, requires_grad=True) for a in (x, y, fx, fy)]
    parts = _flat(ppt.chamfer_distance(ts[0], ts[1], x_features={"n": ts[2]},
                                       y_features={"n": ts[3]},
                                       **{**kw, "weights": _t(w)}))
    assert len(parts) == len(jparts)
    for p, jpart in zip(parts, jparts):
        assert tuple(p.shape) == jpart.shape
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jpart), rtol=TOL, atol=TOL)
    sum((p * (i + 1)).sum() for i, p in enumerate(parts)).backward()
    for t, jg in zip(ts, jgrads):
        assert tuple(t.grad.shape) == jg.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)
