"""The port's ring layer (``pytorch3d_pointops_tpu_torch.parallel``) against
the JAX package's on the CPU: the same numpy inputs, made from a seed, go
through JAX's ``ring_knn_points`` / ``ring_chamfer_distance`` /
``ring_knn_gather`` on the 8-device virtual mesh and through the port's ring
on eight shards of the CPU. Indices must be equal, values within 1e-5 and
gradients within 1e-5 of their largest entry. The JAX ring calls stay few
and small (XLA's in-process CPU collectives abort a rendezvous that waits
40 s); the port's ring is also held against the port's own single-device
ops, bit for bit where the ring should be exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.parallel import make_mesh as jax_make_mesh
from pytorch3d_pointops_tpu.parallel import ring_chamfer_distance as jax_ring_chamfer
from pytorch3d_pointops_tpu.parallel import ring_knn_gather as jax_ring_gather
from pytorch3d_pointops_tpu.parallel import ring_knn_points as jax_ring_knn
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.parallel import (
    make_mesh,
    point_sharding,
    ring_chamfer_distance,
    ring_knn_gather,
    ring_knn_points,
)

torch.set_num_threads(2)
TOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh): eight shards along "sp"."""
    return jax_make_mesh((8,), ("sp",)), make_mesh((8,), ("sp",), devices=CPU8)


def _clouds(seed, N=2, P1=64, P2=96):
    rng = np.random.default_rng(seed)
    p1 = rng.normal(size=(N, P1, 3)).astype(np.float32)
    p2 = rng.normal(size=(N, P2, 3)).astype(np.float32)
    l1 = rng.integers(1, P1 + 1, size=N)
    l2 = rng.integers(1, P2 + 1, size=N)
    return p1, p2, l1, l2


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _check_idx(ref, out):
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _check_vals(ref, out):
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


def _check_grad(ref, out):
    """Within TOL of the reference's largest entry."""
    ref = _np(ref)
    err = np.abs(_np(out) - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _check_single_device(out, p1, p2, l1, l2, K, norm=2):
    """The port's ring against the port's knn_points: indices equal,
    distances bit-equal."""
    ref = ppt.knn_points(_t(p1), _t(p2), _t(l1), _t(l2), K=K, norm=norm)
    assert torch.equal(out.idx, ref.idx)
    assert torch.equal(out.dists, ref.dists)


def _knn_both(meshes, p1, p2, l1, l2, K, norm=2):
    jmesh, tmesh = meshes
    ref = jax_ring_knn(p1, p2, l1, l2, K=K, norm=norm, mesh=jmesh)
    out = ring_knn_points(_t(p1), _t(p2), _t(l1), _t(l2), K=K, norm=norm,
                          mesh=tmesh)
    _check_idx(ref.idx, out.idx)
    _check_vals(ref.dists, out.dists)
    _check_single_device(out, p1, p2, l1, l2, K, norm)
    return out


@pytest.mark.parametrize("norm", [1, 2])
def test_ring_knn_matches_jax(meshes, norm):
    _knn_both(meshes, *_clouds(norm), K=8, norm=norm)


def test_ring_knn_k_exceeds_shard(meshes):
    """K larger than each shard's point count (4 < 6): the merge must pull
    neighbours across hops."""
    _knn_both(meshes, *_clouds(5, P1=32, P2=32), K=6)


def test_ring_knn_empty_shards(meshes):
    """Lengths that leave whole visiting shards empty (0, 1 and P - 1 of
    96 points over shards of 12) and shards smaller than K."""
    p1, p2, _, _ = _clouds(6, N=3)
    _knn_both(meshes, p1, p2, np.array([64, 1, 63]), np.array([0, 1, 95]), K=16)


def _weighted_knn_loss(o):
    w = torch.arange(o.dists.numel(), dtype=torch.float32).reshape(o.dists.shape)
    return (o.dists * w).sum()


def test_ring_knn_gradients_match_jax(meshes):
    jmesh, tmesh = meshes
    p1, p2, l1, l2 = _clouds(2)

    def jloss(a, b):
        o = jax_ring_knn(a, b, l1, l2, K=4, mesh=jmesh)
        w = jnp.arange(o.dists.size, dtype=jnp.float32).reshape(o.dists.shape)
        return (o.dists * w).sum()

    g1, g2 = jax.grad(jloss, (0, 1))(jnp.asarray(p1), jnp.asarray(p2))
    a, b = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    _weighted_knn_loss(ring_knn_points(a, b, _t(l1), _t(l2), K=4, mesh=tmesh)).backward()
    _check_grad(g1, a.grad)
    _check_grad(g2, b.grad)
    # And against the port's single-device backward.
    a2, b2 = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    _weighted_knn_loss(ppt.knn_points(a2, b2, _t(l1), _t(l2), K=4)).backward()
    _check_grad(a2.grad, a.grad)
    _check_grad(b2.grad, b.grad)


def test_ring_knn_with_sharded_inputs(meshes):
    """Inputs placed with ``point_sharding(mesh).shard``, the counterpart of
    JAX's ``device_put`` inputs."""
    jmesh, tmesh = meshes
    from jax.sharding import NamedSharding, PartitionSpec as P

    p1, p2, l1, l2 = _clouds(3)
    sh = NamedSharding(jmesh, P(None, "sp", None))
    ref = jax_ring_knn(jax.device_put(p1, sh), jax.device_put(p2, sh), l1, l2, K=4,
                       mesh=jmesh)
    tsh = point_sharding(tmesh)
    out = ring_knn_points(tsh.shard(_t(p1)), tsh.shard(_t(p2)), _t(l1), _t(l2), K=4,
                          mesh=tmesh)
    _check_idx(ref.idx, out.idx)
    _check_vals(ref.dists, out.dists)
    _check_single_device(out, p1, p2, l1, l2, 4)


def test_ring_chamfer_matches_jax(meshes):
    jmesh, tmesh = meshes
    p1, p2, l1, l2 = _clouds(4)
    ref = jax_ring_chamfer(p1, p2, l1, l2, mesh=jmesh)
    out = ring_chamfer_distance(_t(p1), _t(p2), _t(l1), _t(l2), mesh=tmesh)
    _check_vals(ref, out)
    single, _ = ppt.chamfer_distance(_t(p1), _t(p2), _t(l1), _t(l2))
    _check_vals(single, out)


def test_ring_chamfer_gradient_descent():
    """A sharded chamfer training step reduces the loss, on two shards as
    the JAX test runs it; the first step's loss and gradient match JAX's
    ring."""
    jmesh = jax_make_mesh((2,), ("sp",), devices=jax.devices()[:2])
    tmesh = make_mesh((2,), ("sp",), devices=CPU8[:2])
    rng = np.random.default_rng(7)
    target = rng.normal(size=(1, 64, 3)).astype(np.float32)
    src = (2.0 * rng.normal(size=(1, 64, 3))).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda p: jax_ring_chamfer(p, target, mesh=jmesh))(jnp.asarray(src))
    tgt = _t(target)
    p = _t(src, requires_grad=True)
    first = None
    for it in range(20):
        loss = ring_chamfer_distance(p, tgt, mesh=tmesh)
        loss.backward()
        if first is None:
            first = loss.item()
            _check_vals(jl, loss)
            _check_grad(jg, p.grad)
        with torch.no_grad():
            p -= 1.0 * p.grad
        p.grad = None
    assert loss.item() < 0.5 * first


def test_ring_chamfer_single_directional_gradients(meshes):
    """single_directional runs the K=1 ring KNN; value and gradients match
    JAX's ring and the port's single-device op."""
    jmesh, tmesh = meshes
    p1, p2, l1, l2 = _clouds(17)
    jv, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jax_ring_chamfer(a, b, l1, l2, single_directional=True,
                                      mesh=jmesh),
        argnums=(0, 1))(jnp.asarray(p1), jnp.asarray(p2))
    a, b = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    loss = ring_chamfer_distance(a, b, _t(l1), _t(l2), single_directional=True,
                                 mesh=tmesh)
    loss.backward()
    _check_vals(jv, loss)
    _check_grad(jg1, a.grad)
    _check_grad(jg2, b.grad)
    a2, b2 = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    ppt.chamfer_distance(a2, b2, _t(l1), _t(l2), single_directional=True)[0].backward()
    _check_grad(a2.grad, a.grad)
    _check_grad(b2.grad, b.grad)


def test_ring_2d_mesh_dp_plus_sp():
    """Batch split over dp while points ring over sp, 2 x 4, for KNN and
    for the chamfer loss with its gradients."""
    jmesh = jax_make_mesh((2, 4), ("dp", "sp"))
    tmesh = make_mesh((2, 4), ("dp", "sp"), devices=CPU8)
    p1, p2, l1, l2 = _clouds(6, N=4, P1=32, P2=64)
    kw = dict(point_axis="sp", batch_axis="dp")
    ref = jax_ring_knn(p1, p2, l1, l2, K=4, mesh=jmesh, **kw)
    out = ring_knn_points(_t(p1), _t(p2), _t(l1), _t(l2), K=4, mesh=tmesh, **kw)
    _check_idx(ref.idx, out.idx)
    _check_vals(ref.dists, out.dists)
    _check_single_device(out, p1, p2, l1, l2, 4)
    a, b = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    loss = ring_chamfer_distance(a, b, _t(l1), _t(l2), mesh=tmesh, **kw)
    loss.backward()
    a2, b2 = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    single, _ = ppt.chamfer_distance(a2, b2, _t(l1), _t(l2))
    single.backward()
    _check_vals(single, loss)
    _check_grad(a2.grad, a.grad)
    _check_grad(b2.grad, b.grad)


def test_ring_validation(meshes):
    _, tmesh = meshes
    p1 = torch.zeros((2, 64, 3))
    with pytest.raises(ValueError):  # batch mismatch
        ring_knn_points(p1, torch.zeros((3, 64, 3)), K=4, mesh=tmesh)
    with pytest.raises(ValueError):  # dim mismatch
        ring_knn_points(p1, torch.zeros((2, 64, 2)), K=4, mesh=tmesh)
    with pytest.raises(ValueError):  # bad norm
        ring_knn_points(p1, p1, norm=3, K=4, mesh=tmesh)
    with pytest.raises(ValueError):  # no such mesh axis
        ring_knn_points(p1, p1, K=4, mesh=tmesh, point_axis="dp")
    with pytest.raises(ValueError):  # a batch that does not split over dp
        ring_knn_points(torch.zeros((3, 8, 3)), torch.zeros((3, 8, 3)), K=2,
                        mesh=make_mesh((2, 4), ("dp", "sp"), devices=CPU8),
                        batch_axis="dp")


def test_ring_chamfer_with_features_matches_jax(meshes):
    """Feature cosine terms on the ring (the differentiable ring gather)
    match JAX's ring, forward and backward, and the single-device op."""
    jmesh, tmesh = meshes
    p1, p2, l1, l2 = _clouds(11)
    rng = np.random.default_rng(12)
    f1 = {"normals": rng.normal(size=(2, 64, 3)).astype(np.float32)}
    f2 = {"normals": rng.normal(size=(2, 96, 3)).astype(np.float32)}

    def jloss(a, b, fa, fb):
        loss, lf = jax_ring_chamfer(a, b, l1, l2, x_features=fa, y_features=fb,
                                    feature_names=["normals"], mesh=jmesh)
        return loss + lf["normals"]

    jv, jg = jax.value_and_grad(jloss, (0, 1, 2, 3))(p1, p2, f1, f2)
    ins = [_t(p1, requires_grad=True), _t(p2, requires_grad=True),
           {"normals": _t(f1["normals"], requires_grad=True)},
           {"normals": _t(f2["normals"], requires_grad=True)}]
    loss, lf = ring_chamfer_distance(ins[0], ins[1], _t(l1), _t(l2),
                                     x_features=ins[2], y_features=ins[3],
                                     feature_names=["normals"], mesh=tmesh)
    (loss + lf["normals"]).backward()
    _check_vals(jv, loss + lf["normals"])
    _check_grad(jg[0], ins[0].grad)
    _check_grad(jg[1], ins[1].grad)
    _check_grad(jg[2]["normals"], ins[2]["normals"].grad)
    _check_grad(jg[3]["normals"], ins[3]["normals"].grad)
    single, slf = ppt.chamfer_distance(
        _t(p1), _t(p2), _t(l1), _t(l2), {"normals": _t(f1["normals"])},
        {"normals": _t(f2["normals"])}, feature_names=["normals"])
    _check_vals(single, loss)
    _check_vals(slf["normals"], lf["normals"])


@pytest.mark.parametrize("single_directional", [False, True])
def test_ring_chamfer_unreduced_with_features_matches_jax(meshes, single_directional):
    """point_reduction=None on shapes that do not divide the ring: the
    un-reduced terms are trimmed back to the caller's point counts."""
    jmesh, tmesh = meshes
    p1, p2, l1, l2 = _clouds(13, P1=30, P2=45)
    rng = np.random.default_rng(14)
    f1 = {"c": rng.uniform(size=(2, 30, 3)).astype(np.float32)}
    f2 = {"c": rng.uniform(size=(2, 45, 3)).astype(np.float32)}
    kw = dict(point_reduction=None, batch_reduction=None, feature_names=["c"],
              single_directional=single_directional)
    ref, rf = jax_ring_chamfer(p1, p2, l1, l2, f1, f2, mesh=jmesh, **kw)
    out, of = ring_chamfer_distance(_t(p1), _t(p2), _t(l1), _t(l2),
                                    {"c": _t(f1["c"])}, {"c": _t(f2["c"])},
                                    mesh=tmesh, **kw)
    pairs = [(ref, out), (rf["c"], of["c"])]
    if not single_directional:
        pairs = [(r, o) for a, b in pairs for r, o in zip(a, b)]
    for r, o in pairs:
        assert tuple(o.shape) == np.asarray(r).shape
        _check_vals(r, o)


def test_ring_knn_gather_matches_jax(meshes):
    """The ring gather alone: values and the gradient of the values, with
    lengths that zero-fill k >= lengths[n]."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 96, 5)).astype(np.float32)
    idx = rng.integers(0, 96, size=(2, 64, 3))
    lens = np.array([96, 2])
    w = rng.normal(size=(2, 64, 3, 5)).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda v: (jax_ring_gather(v, jnp.asarray(idx, jnp.int32), lens,
                                   mesh=jmesh) * w).sum())(jnp.asarray(x))
    tx = _t(x, requires_grad=True)
    out = ring_knn_gather(tx, _t(idx), _t(lens), mesh=tmesh)
    (out * _t(w)).sum().backward()
    _check_vals(jv, (out * _t(w)).sum())
    _check_grad(jg, tx.grad)
    tx2 = _t(x, requires_grad=True)
    single = ppt.knn_gather(tx2, _t(idx), _t(lens))
    (single * _t(w)).sum().backward()
    assert torch.equal(out, single)
    _check_grad(tx2.grad, tx.grad)


def test_ring_knn_auto_pads_non_divisible_shapes(meshes):
    """Shapes that do not divide the ring size (100 and 77 over 8) run
    unmodified and match."""
    rng = np.random.default_rng(3)
    p1 = rng.normal(size=(2, 100, 3)).astype(np.float32)
    p2 = rng.normal(size=(2, 77, 3)).astype(np.float32)
    _knn_both(meshes, p1, p2, np.array([100, 60]), np.array([77, 50]), K=4)


def test_ring_chamfer_validates_reductions(meshes):
    _, tmesh = meshes
    x = torch.zeros((2, 16, 3))
    with pytest.raises(ValueError):
        ring_chamfer_distance(x, x, batch_reduction="bogus", point_reduction="mean",
                              mesh=tmesh)
    with pytest.raises(ValueError):
        ring_chamfer_distance(x, x, batch_reduction="mean", point_reduction="bogus",
                              mesh=tmesh)
    with pytest.raises(ValueError):
        ring_chamfer_distance(x, x, x_features={"a": x}, y_features={"a": x},
                              feature_names=["a"], point_reduction="max", mesh=tmesh)


def test_ring_knn_cross_shard_exact_ties(meshes):
    """Duplicate points straddling shard boundaries: the (distance, index)
    merge keeps the lowest global index on exact cross-shard ties."""
    rng = np.random.default_rng(77)
    P1, P2 = 64, 96  # 8 shards of 12 p2 points / 8 p1 rows a shard
    p2 = rng.normal(size=(1, P2, 3)).astype(np.float32)
    # global 5 (shard 0) == 29 (shard 2) == 50 (shard 4); 17 == 89
    p2[:, 29] = p2[:, 5]
    p2[:, 50] = p2[:, 5]
    p2[:, 89] = p2[:, 17]
    p1 = np.tile(p2[:, [5, 29, 50, 17, 89, 5, 17, 50]], (1, 8, 1))
    _knn_both(meshes, p1, p2, np.array([P1]), np.array([P2]), K=8)


def test_ring_knn_quantized_tie_fuzz(meshes):
    """Clouds on a tiny grid, so exact ties abound within and across
    shards; the indices stay exact."""
    rng = np.random.default_rng(88)
    p1 = rng.integers(0, 3, size=(2, 32, 3)).astype(np.float32)
    p2 = rng.integers(0, 3, size=(2, 64, 3)).astype(np.float32)
    _knn_both(meshes, p1, p2, np.array([32, 20]), np.array([64, 41]), K=10)


@pytest.mark.parametrize("kwargs", [
    dict(point_reduction="max", batch_reduction="mean"),
    dict(weights=[0.5, 2.0]),
    dict(weights=[0.5, 2.0], single_directional=True, batch_reduction="sum"),
], ids=["max", "weights", "weights-single-sum"])
def test_ring_chamfer_max_and_weights_match_jax(meshes, kwargs):
    """Hausdorff (max, with its gradient) and per-batch weights through the
    ring match JAX's ring and the single-device op; negative weights
    raise."""
    jmesh, tmesh = meshes
    p1, p2, l1, l2 = _clouds(91)
    jkw = {k: (np.asarray(v, np.float32) if k == "weights" else v)
           for k, v in kwargs.items()}
    tkw = {k: (_t(v) if k == "weights" else v) for k, v in jkw.items()}
    jv, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jax_ring_chamfer(a, b, l1, l2, mesh=jmesh, **jkw),
        argnums=(0, 1))(jnp.asarray(p1), jnp.asarray(p2))
    a, b = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    loss = ring_chamfer_distance(a, b, _t(l1), _t(l2), mesh=tmesh, **tkw)
    loss.backward()
    _check_vals(jv, loss)
    _check_grad(jg1, a.grad)
    _check_grad(jg2, b.grad)
    _check_vals(ppt.chamfer_distance(_t(p1), _t(p2), _t(l1), _t(l2), **tkw)[0], loss)
    with pytest.raises(ValueError, match="weights cannot be negative."):
        ring_chamfer_distance(_t(p1), _t(p2), _t(l1), _t(l2),
                              weights=_t(np.array([-1.0, 1.0])), mesh=tmesh)


def test_ring_gradients_bit_equal_across_runs(meshes):
    """Two backward runs of the ring give the same gradients bit for bit:
    ring KNN, and the ring chamfer with features."""
    _, tmesh = meshes
    p1, p2, l1, l2 = _clouds(21)
    rng = np.random.default_rng(22)
    f1 = rng.normal(size=(2, 64, 3)).astype(np.float32)
    f2 = rng.normal(size=(2, 96, 3)).astype(np.float32)
    runs = []
    for _ in range(2):
        a, b = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
        fa, fb = _t(f1, requires_grad=True), _t(f2, requires_grad=True)
        _weighted_knn_loss(ring_knn_points(a, b, _t(l1), _t(l2), K=5,
                                           mesh=tmesh)).backward()
        loss, lf = ring_chamfer_distance(a, b, _t(l1), _t(l2), {"n": fa}, {"n": fb},
                                         feature_names=["n"], mesh=tmesh)
        (loss + lf["n"]).backward()
        runs.append([a.grad, b.grad, fa.grad, fb.grad])
    for g0, g1 in zip(*runs):
        assert torch.equal(g0, g1)


def _ring_empty_leaves(fn, *arrays):
    """``fn(*tensors)``'s outputs (a KNN tuple, a tensor, or a chamfer loss
    with its features) as numpy arrays, then the gradients of a weighted
    sum of them with respect to every input of floating point."""
    ts = [_t(a, requires_grad=a.dtype == np.float32) for a in arrays]
    out = fn(*ts)
    if isinstance(out, tuple) and hasattr(out, "dists"):
        leaves = [out.dists, out.idx] + ([out.knn] if out.knn is not None else [])
    elif isinstance(out, tuple):
        leaves = _chamfer_parts(out)
    else:
        leaves = [out]
    total = sum((v * (i + 1)).sum() for i, v in enumerate(leaves) if v.is_floating_point())
    inputs = [t for t in ts if t.requires_grad]
    grads = torch.autograd.grad(total, inputs, allow_unused=True) if total.requires_grad \
        else [None] * len(inputs)
    return ([_np(v) for v in leaves]
            + [_np(g) if g is not None else np.zeros(t.shape, np.float32)
               for g, t in zip(grads, inputs)])


def _chamfer_parts(out):
    """The tensors of a chamfer result: ``(loss, features)``, or the ring's
    ``loss`` alone (a tensor or, unreduced, a pair of tensors)."""
    features = isinstance(out, tuple) and (out[1] is None or isinstance(out[1], dict))
    loss, feats = out if features else (out, None)
    parts = list(loss) if isinstance(loss, tuple) else [loss]
    return parts + [feats[k] for k in sorted(feats or {})]


_E = np.random.default_rng(12)
_P1 = _E.normal(size=(2, 16, 3)).astype(np.float32)
_P2 = _E.normal(size=(2, 16, 3)).astype(np.float32)
_F1 = _E.normal(size=(2, 16, 2)).astype(np.float32)
_NONE = np.zeros((2, 0, 3), np.float32)
_IDX = np.zeros((2, 16, 3), np.int64)
# (label, inputs, ring call, single-device call); each call takes the inputs
# as tensors and the ring call also the port's eight-shard mesh.
RING_EMPTY = [
    ("knn P2=0 return_nn", (_P1, _NONE),
     lambda m, a, b: ring_knn_points(a, b, K=2, mesh=m, return_nn=True),
     lambda a, b: ppt.knn_points(a, b, K=2, return_nn=True)),
    ("knn K=0", (_P1, _P2),
     lambda m, a, b: ring_knn_points(a, b, K=0, mesh=m, return_nn=True),
     lambda a, b: ppt.knn_points(a, b, K=0, return_nn=True)),
    ("knn P1=0", (_NONE, _P2),
     lambda m, a, b: ring_knn_points(a, b, K=2, norm=1, mesh=m, return_nn=True),
     lambda a, b: ppt.knn_points(a, b, K=2, norm=1, return_nn=True)),
    ("knn N=0", (_P1[:0], _P2[:0]),
     lambda m, a, b: ring_knn_points(a, b, K=2, mesh=m),
     lambda a, b: ppt.knn_points(a, b, K=2)),
    ("gather P=0", (_NONE, _IDX),
     lambda m, x, i: ring_knn_gather(x, i, mesh=m),
     lambda x, i: ppt.knn_gather(x, i)),
    ("gather K=0", (_P2, _IDX[..., :0]),
     lambda m, x, i: ring_knn_gather(x, i, mesh=m),
     lambda x, i: ppt.knn_gather(x, i)),
    ("chamfer P2=0 single_directional", (_P1, _NONE),
     lambda m, a, b: ring_chamfer_distance(a, b, single_directional=True, mesh=m),
     lambda a, b: ppt.chamfer_distance(a, b, single_directional=True)),
    ("chamfer P2=0 features", (_P1, _NONE, _F1, _NONE[..., :2]),
     lambda m, a, b, fa, fb: ring_chamfer_distance(
         a, b, x_features={"n": fa}, y_features={"n": fb}, feature_names=["n"],
         weights=torch.tensor([1.0, 2.0]), mesh=m),
     lambda a, b, fa, fb: ppt.chamfer_distance(
         a, b, x_features={"n": fa}, y_features={"n": fb}, feature_names=["n"],
         weights=torch.tensor([1.0, 2.0]))),
    ("chamfer P1=0 unreduced", (_NONE, _P2),
     lambda m, a, b: ring_chamfer_distance(a, b, point_reduction=None,
                                           batch_reduction=None, norm=1, mesh=m),
     lambda a, b: ppt.chamfer_distance(a, b, point_reduction=None,
                                       batch_reduction=None, norm=1)),
]


@pytest.mark.parametrize("case", RING_EMPTY, ids=[c[0] for c in RING_EMPTY])
def test_ring_empty_dimensions_match_single_device(meshes, case):
    """Each ring entry point on an empty dimension or K = 0 against the
    port's single-device op on the same inputs, whose semantics the ring
    keeps: outputs and gradients of their shapes, indices equal, values
    within 1e-5. JAX's ring crashes on most of these (an XLA sharding
    assertion at K = 0, P1 = 0, N = 0 and in the KNN backward at P2 = 0; a
    minimum over an empty array in the bidirectional chamfer); where it
    returns, the next test holds the port's ring to it."""
    _, tmesh = meshes
    _, arrays, ring_fn, single_fn = case
    got = _ring_empty_leaves(lambda *ts: ring_fn(tmesh, *ts), *arrays)
    want = _ring_empty_leaves(single_fn, *arrays)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_ring_empty_dimensions_match_jax(meshes):
    """Where JAX's ring returns on an empty dimension, the port's ring gives
    its outputs: KNN with an empty y cloud and return_nn, the gather of an
    empty value cloud, the single-directional chamfer with an empty y
    cloud."""
    jmesh, tmesh = meshes
    ref = jax_ring_knn(_P1, _NONE, K=2, mesh=jmesh, return_nn=True)
    out = ring_knn_points(_t(_P1), _t(_NONE), K=2, mesh=tmesh, return_nn=True)
    _check_idx(ref.idx, out.idx)
    _check_vals(ref.dists, out.dists)
    _check_vals(ref.knn, out.knn)
    ref = jax_ring_gather(_NONE, _IDX, mesh=jmesh)
    out = ring_knn_gather(_t(_NONE), _t(_IDX), mesh=tmesh)
    assert tuple(out.shape) == ref.shape
    _check_vals(ref, out)
    ref = jax_ring_chamfer(_P1, _NONE, single_directional=True, mesh=jmesh)
    out = ring_chamfer_distance(_t(_P1), _t(_NONE), single_directional=True, mesh=tmesh)
    _check_vals(ref, out)
