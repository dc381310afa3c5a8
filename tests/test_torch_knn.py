"""The PyTorch port's knn_points / knn_gather / KNN kernel module against the
JAX package, on the CPU: the same numpy inputs go through both. Values and
gradients must agree to 1e-5; indices exactly on 1/8-grid data with
duplicate points, and on random data wherever neighbouring distances differ
by more than 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels.knn_pallas import knn_forward_pallas
from pytorch3d_pointops_tpu.ops.knn import _knn_forward_full as jax_knn_forward_full
from pytorch3d_pointops_tpu.ops.knn import knn_backward as jax_knn_backward
from pytorch3d_pointops_tpu.ops.knn import knn_gather as jax_knn_gather
from pytorch3d_pointops_tpu.ops.knn import knn_points as jax_knn_points
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.kernels import knn as kk
from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions, knn_backward

torch.set_num_threads(2)
TOL = 1e-5


def _clouds(seed, N, P1, P2, D=3, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        p1 = rng.integers(-2, 3, size=(N, P1, D)).astype(np.float32) / 8
        p2 = rng.integers(-2, 3, size=(N, P2, D)).astype(np.float32) / 8
    else:
        p1 = rng.normal(size=(N, P1, D)).astype(np.float32)
        p2 = rng.normal(size=(N, P2, D)).astype(np.float32)
    l1 = rng.integers(1, P1 + 1, size=N)
    l2 = rng.integers(1, P2 + 1, size=N)
    l1[0], l2[0] = P1, P2
    return p1, p2, l1, l2


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _separated(d):
    """(N, P1, K) mask of slots whose distance differs from both sorted
    neighbours by more than TOL: there the index must be unique."""
    gap = np.diff(d, axis=-1) > TOL
    left = np.concatenate([np.ones_like(gap[..., :1]), gap], axis=-1)
    right = np.concatenate([gap, np.ones_like(gap[..., :1])], axis=-1)
    return left & right


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("K", [1, 4, 70])
def test_knn_points_matches_jax(norm, K):
    p1, p2, l1, l2 = _clouds(K + norm, 2, 24, 90)
    l2[1] = 37  # K=70 > lengths2 on the second cloud
    w = np.random.default_rng(5).normal(size=(2, 24, K)).astype(np.float32)

    ref = jax_knn_points(p1, p2, l1, l2, norm=norm, K=K, impl="xla")
    gj1, gj2 = jax.grad(
        lambda a, b: jnp.sum(
            w * jax_knn_points(a, b, l1, l2, norm=norm, K=K, impl="xla").dists
        ),
        argnums=(0, 1),
    )(jnp.asarray(p1), jnp.asarray(p2))

    t1 = _t(p1, requires_grad=True)
    t2 = _t(p2, requires_grad=True)
    out = ppt.knn_points(t1, t2, _t(l1), _t(l2), norm=norm, K=K)
    (out.dists * _t(w)).sum().backward()

    rd, ri = np.asarray(ref.dists), np.asarray(ref.idx)
    np.testing.assert_allclose(out.dists.detach().numpy(), rd, rtol=TOL, atol=TOL)
    sep = _separated(rd)
    np.testing.assert_array_equal(out.idx.numpy()[sep], ri[sep])
    assert out.idx.dtype == torch.int64
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(gj1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(gj2), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("norm", [1, 2])
def test_knn_grid_duplicates_exact_indices(norm):
    """1/8-grid points with many duplicates: ties resolve to the lowest
    index, exactly as in the JAX package."""
    p1, p2, l1, l2 = _clouds(10 + norm, 3, 30, 80, grid=True)
    for K in (1, 6, 70):
        ref = jax_knn_points(p1, p2, l1, l2, norm=norm, K=K, impl="xla")
        out = ppt.knn_points(_t(p1), _t(p2), _t(l1), _t(l2), norm=norm, K=K)
        np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_allclose(out.dists.numpy(), np.asarray(ref.dists), atol=TOL)


@pytest.mark.parametrize("K", [1, 4])
def test_plain_twin_matches_pallas_kernel(K):
    """The kernel module's plain twin against the TPU kernel itself, run in
    interpret mode at tiny tiles, before the pad conventions."""
    p1, p2, _, l2 = _clouds(3, 2, 40, 90, grid=True)
    d_pal, i_pal = knn_forward_pallas(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2), K=K, norm=2,
        tile_p1=32, tile_p2=64, interpret=True,
    )
    d, i = kk.knn_topk(_t(p1), _t(p2), _t(l2), K, 2)
    for n in range(2):
        kv = min(K, int(l2[n]))
        np.testing.assert_allclose(
            d.numpy()[n, :, :kv], np.asarray(d_pal)[n, :, :kv], atol=TOL
        )
        np.testing.assert_array_equal(
            i.numpy()[n, :, :kv], np.asarray(i_pal)[n, :, :kv]
        )
        assert np.isinf(d.numpy()[n, :, kv:]).all()


def test_plain_twin_tiled_equals_full():
    """The streamed plain version (large problems) and the single-shot one
    give the same (value, index) order, ties included."""
    p1, p2, _, l2 = _clouds(4, 2, 50, 300, grid=True)
    args = (_t(p1), _t(p2), _t(l2))
    for K in (1, 5, 40):
        full_d, full_i = kk._knn_forward_full(*args, K, 2)
        tiled_d, tiled_i = map(torch.stack, zip(*[
            kk._knn_single_tiled(args[0][n], args[1][n], args[2][n], K, 2, 64)
            for n in range(2)
        ]))
        valid = (torch.arange(K)[None, None, :] < args[2][:, None, None]).expand_as(
            full_i
        )
        assert torch.equal(tiled_i[valid], full_i[valid])
        assert torch.equal(tiled_d[valid], full_d[valid])


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("K", [1, 16, 70])
def test_knn_ties_at_ragged_sizes_match_jax(norm, K):
    """1/8-grid points (distance-0 and equal-distance ties everywhere) at
    sizes that are no multiple of any block, tile or group of the kernel,
    with lengths2 ending mid-group: indices exactly the JAX package's."""
    p1, p2, l1, l2 = _clouds(20 + K + norm, 2, 301, 523, grid=True)
    l1[1], l2[1] = 299, 261
    ref = jax_knn_points(p1, p2, l1, l2, norm=norm, K=K, impl="xla")
    out = ppt.knn_points(_t(p1), _t(p2), _t(l1), _t(l2), norm=norm, K=K)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(out.dists.numpy(), np.asarray(ref.dists), atol=TOL)


def _fits(blocks_per_sm):
    """A stand-in for the card's occupancy query: the same number of
    resident blocks for every plan."""
    return lambda plan: blocks_per_sm


# (N, P1, P2, D, K): the north star, config 1, 16 x 10,000, a single query,
# an empty query set, ragged widths, K past one round, wide points.
_PLAN_SHAPES = [
    (1, 100_000, 100_000, 3, 16), (2, 1000, 1000, 3, 8), (16, 10_000, 10_000, 3, 16),
    (1, 1, 1, 3, 1), (1, 0, 50, 3, 4), (3, 1337, 2061, 5, 32), (1, 100_000, 777, 3, 100),
    (4, 700, 900, 16, 8), (2, 50, 60, 200, 1),
]


@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_launch_plan_never_zero_blocks(shape):
    N, P1, P2, D, K = shape
    plan = kk._launch_plan(N, P1, P2, D, K, 132, _fits(2))
    assert plan.queries <= kk._max_queries(K, D)
    assert plan.threads in kk._THREADS and plan.tile >= 1
    if N * P1:
        blocks = kk._blocks(N, P1, plan)
        assert blocks >= 1 and blocks * plan.queries * plan.threads >= N * P1


@pytest.mark.parametrize("shape", [(2, 1000, 1000, 3, 8), (1, 4000, 9000, 3, 16),
                                   (8, 300, 300, 5, 4), (1, 100, 100_000, 3, 1)])
def test_launch_plan_q1_when_blocks_fewer_than_sms(shape):
    N, P1, P2, D, K = shape
    assert N * -(-P1 // (2 * 32)) < 132
    assert kk._launch_plan(N, P1, P2, D, K, 132, _fits(4)).queries == 1


@pytest.mark.parametrize("K", [65, 100, 128, 1000])
def test_launch_plan_big_k_is_64_key_rounds(K):
    """K > 64 runs chained 64-key rounds, planned as K = 64: one query a
    thread (the 64-bucket's state is 128 registers)."""
    for N, P1, P2 in ((1, 100_000, 100_000), (16, 10_000, 10_000)):
        plan = kk._launch_plan(N, P1, P2, 3, K, 132, _fits(3))
        assert plan == kk._launch_plan(N, P1, P2, 3, 64, 132, _fits(3))
        assert plan.queries == 1
        assert all(p.queries == 1 for p in kk.feasible_plans(N, P1, P2, 3, K, _fits(3)))


@pytest.mark.parametrize("D", [9, 16, 100, 6144, 20000])
def test_launch_plan_wide_points_take_the_generic_path(D):
    """D > 8 is the kernel's any-D instance: one query a thread, two tiles
    of D floats a candidate in the default 48 KB where a candidate fits."""
    plan = kk._launch_plan(16, 10_000, 10_000, D, 16, 132, _fits(2))
    assert plan.queries == 1
    assert 2 * plan.tile * D * 4 <= max(48 * 1024, 2 * D * 4)
    assert plan.tile == 1 or plan.tile % 16 == 0
    assert all(p.queries == 1 for p in kk.feasible_plans(16, 10_000, 10_000, D, 16, _fits(2)))


def test_launch_plan_needs_a_resident_block():
    with pytest.raises(RuntimeError):
        kk._launch_plan(1, 1000, 1000, 3, 8, 132, _fits(0))


def test_knn_k_greater_than_p2():
    p1, p2, l1, l2 = _clouds(6, 2, 12, 5)
    ref = jax_knn_points(p1, p2, l1, l2, K=9, impl="xla")
    out = ppt.knn_points(_t(p1), _t(p2), _t(l1), _t(l2), K=9)
    np.testing.assert_allclose(out.dists.numpy(), np.asarray(ref.dists), atol=TOL)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))


def test_knn_unsorted_and_return_nn():
    p1, p2, l1, l2 = _clouds(7, 2, 16, 40, grid=True)
    ref = jax_knn_points(p1, p2, l1, l2, K=6, return_sorted=False,
                         return_nn=True, impl="xla")
    out = ppt.knn_points(_t(p1), _t(p2), _t(l1), _t(l2), K=6,
                         return_sorted=False, return_nn=True)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(out.dists.numpy(), np.asarray(ref.dists), atol=TOL)
    np.testing.assert_allclose(out.knn.numpy(), np.asarray(ref.knn), atol=TOL)


def test_knn_wide_points_match_jax_einsum_path():
    """D=16: the port sums axis by axis, the JAX package takes a
    HIGHEST-precision matrix product; values agree to 1e-5."""
    p1, p2, l1, l2 = _clouds(8, 2, 20, 50, D=16)
    ref = jax_knn_points(p1, p2, l1, l2, K=5, impl="xla")
    out = ppt.knn_points(_t(p1), _t(p2), _t(l1), _t(l2), K=5)
    rd = np.asarray(ref.dists)
    np.testing.assert_allclose(out.dists.numpy(), rd, rtol=TOL, atol=1e-4)
    sep = _separated(rd / np.maximum(rd.max(), 1.0))
    np.testing.assert_array_equal(out.idx.numpy()[sep], np.asarray(ref.idx)[sep])


def test_knn_backward_skips_negative_indices():
    p1, p2, l1, l2 = _clouds(9, 2, 10, 20)
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 20, size=(2, 10, 3))
    g = rng.normal(size=(2, 10, 3)).astype(np.float32)
    for norm in (1, 2):
        r1, r2 = jax_knn_backward(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l1), jnp.asarray(l2),
            jnp.asarray(idx.astype(np.int32)), norm, jnp.asarray(g),
        )
        g1, g2 = knn_backward(_t(p1), _t(p2), _t(l1), _t(l2), _t(idx), norm, _t(g))
        np.testing.assert_allclose(g1.numpy(), np.asarray(r1), atol=TOL)
        np.testing.assert_allclose(g2.numpy(), np.asarray(r2), atol=TOL)


def test_knn_gather_and_its_gradient():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 15, 4)).astype(np.float32)
    idx = rng.integers(0, 15, size=(2, 7, 3))
    lengths = np.array([15, 2])
    w = rng.normal(size=(2, 7, 3, 4)).astype(np.float32)
    ref = jax_knn_gather(jnp.asarray(x), jnp.asarray(idx.astype(np.int32)),
                         jnp.asarray(lengths))
    gref = jax.grad(lambda a: jnp.sum(w * jax_knn_gather(
        a, jnp.asarray(idx.astype(np.int32)), jnp.asarray(lengths))))(jnp.asarray(x))
    tx = _t(x, requires_grad=True)
    out = ppt.knn_gather(tx, _t(idx), _t(lengths))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gref), atol=TOL)


def test_knn_check_version():
    from pytorch3d_pointops_tpu.ops.knn import knn_check_version as ref

    for v in range(-1, 5):
        for D, K in ((3, 1), (3, 8), (16, 40), (40, 2)):
            assert ppt.knn_check_version(v, D, K) == ref(v, D, K)


def test_wrappers_launch_or_raise():
    """A tensor that is neither CPU nor CUDA raises, and the CUDA wrapper
    refuses CPU tensors instead of running the plain version."""
    p = torch.zeros((1, 4, 3), device="meta")
    lengths = torch.zeros((1,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kk.knn_topk(p, p, lengths, 2, 2)
    with pytest.raises(ValueError):
        kk.knn_topk_cuda(torch.zeros((1, 4, 3)), torch.zeros((1, 4, 3)),
                         torch.zeros((1,), dtype=torch.int64), 2, 2)
    with pytest.raises(ValueError):
        ppt.knn_points(torch.zeros((1, 4, 3)), torch.zeros((1, 4, 3)), norm=3)


def _sort_case(cloud, seed):
    """(p1, p2, lengths2) for the sorted-KNN cases: "dup", two clouds where
    every candidate appears twice and every fourth query is a candidate;
    "ragged", three clouds with lengths2 of 0, 1 and P2 - 1 and garbage
    coordinates (up to 1e3) past them; "grid", 1/8-grid points."""
    rng = np.random.default_rng(seed)
    if cloud == "dup":
        base = rng.normal(size=(2, 256, 3)).astype(np.float32)
        p2 = np.concatenate([base, base], axis=1)
        p1 = rng.normal(size=(2, 130, 3)).astype(np.float32)
        p1[:, ::4] = base[:, rng.integers(0, 256, size=33)]
        return p1, p2, np.array([512 - 3, 500])
    if cloud == "ragged":
        p1 = rng.normal(size=(3, 150, 3)).astype(np.float32)
        p2 = rng.normal(size=(3, 400, 3)).astype(np.float32)
        lengths2 = np.array([0, 1, 399])
        for n, length in enumerate(lengths2):
            p2[n, length:] = rng.uniform(-1e3, 1e3, size=(400 - length, 3))
        return p1, p2, lengths2
    p1, p2, _, l2 = _clouds(seed, 2, 140, 333, grid=True)
    return p1, p2, l2


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("K", [4, 16, 100])
@pytest.mark.parametrize("cloud", ["dup", "ragged", "grid"])
def test_sorted_knn_equals_unsorted_and_jax(cloud, K, norm):
    """Query sorting on CPU tensors (the plain twin behind the same
    permutation) gives indices equal and distances bit-equal to the
    unsorted plain path, pads and ties included, and indices equal to the
    JAX kernel with both of its sorts on (interpret mode; K=100 against the
    JAX package's single-shot forward)."""
    p1, p2, l2 = _sort_case(cloud, K + norm)
    args = (_t(p1), _t(p2), _t(l2))
    d0, i0 = kk.knn_topk(*args, K, norm, sort_queries=False)
    d, i = kk.knn_topk(*args, K, norm, sort_queries=True)
    assert torch.equal(i, i0)
    assert torch.equal(d, d0)

    N, P1 = p1.shape[:2]
    if K <= 16:
        d_ref, i_ref = knn_forward_pallas(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2), K=K, norm=norm,
            tile_p1=32, tile_p2=128, interpret=True, sort_queries=True,
            sort_candidates=True)
    else:
        d_ref, i_ref = jax_knn_forward_full(
            jnp.asarray(p1), jnp.asarray(p2), jnp.full((N,), P1), jnp.asarray(l2),
            K, norm)
    full = torch.full((N,), P1)
    d0, i0 = _apply_pad_conventions(d0, i0, full, args[2], K, P1)
    d_ref, i_ref = _apply_pad_conventions(_t(d_ref), _t(i_ref).long(), full, args[2],
                                          K, P1)
    assert torch.equal(i0, i_ref)
    np.testing.assert_allclose(d0.numpy(), d_ref.numpy(), atol=TOL)


@pytest.mark.parametrize("D", [1, 2, 5])
def test_sorted_knn_any_dimension(D):
    """D < 3 codes fewer axes, D > 3 the first three: results unchanged."""
    p1, p2, l1, l2 = _clouds(40 + D, 2, 90, 210, D=D, grid=True)
    args = (_t(p1), _t(p2), _t(l2))
    d0, i0 = kk.knn_topk(*args, 7, 2)
    d, i = kk.knn_topk(*args, 7, 2, sort_queries=True)
    assert torch.equal(i, i0) and torch.equal(d, d0)


def test_sort_gates_and_unserved_requests_raise():
    """The auto gate is off on the CPU and for K=1; an explicit choice
    stands. The counters exist only for the kernel instances that serve
    them (D=3, norm 2, 5 <= K <= 64): asked for elsewhere they raise before
    any launch."""
    assert kk.sort_gates(10**12, 16, False) is False
    assert kk.sort_gates(10**12, 1, True) is False
    assert kk.sort_gates(10**12, 16, True) is True
    assert kk.sort_gates(16 * 10**8, 16, True) is False
    # Each K bucket's threshold (SORT_QUERIES_MIN_PAIRS), K > 64 as 64.
    for pairs, K, on in ((10**10, 16, False), (10**11, 9, True), (10**12, 8, False),
                         (5 * 10**9, 32, False), (6 * 10**9, 17, True),
                         (16 * 10**8, 64, False), (2 * 10**9, 33, True),
                         (25 * 10**8, 100, True)):
        assert kk.sort_gates(pairs, K, True) is on, (pairs, K)
    assert kk.sort_gates(10, 1, False, True) is True
    assert kk.sort_gates(10**12, 16, True, False) is False
    p = torch.zeros((1, 40, 3))
    l2 = torch.full((1,), 40)
    for K, norm in ((1, 2), (4, 2), (100, 2), (16, 1)):
        with pytest.raises(ValueError, match="counting"):
            kk.knn_topk_cuda(p, p, l2, K, norm, instrument=True)


@pytest.mark.parametrize("norm", [1, 2])
def test_knn_backward_with_empty_p2(norm):
    """p2 with no point (N=2, P1=5, P2=0, K=2): the forward pads every slot
    (distance 0, index 0) and the backward gathers nothing: zero gradients
    of p1's and p2's shapes, as JAX gives. It used to gather p2 at index 0
    (``index 0 is out of bounds``; on the card a device-side assert)."""
    p1 = np.random.default_rng(9).normal(size=(2, 5, 3)).astype(np.float32)
    p2 = np.zeros((2, 0, 3), np.float32)
    g = np.random.default_rng(10).normal(size=(2, 5, 2)).astype(np.float32)
    ref, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jnp.sum(g * jax_knn_points(a, b, K=2, norm=norm).dists),
        argnums=(0, 1))(jnp.asarray(p1), jnp.asarray(p2))
    a, b = _t(p1, requires_grad=True), _t(p2, requires_grad=True)
    out = ppt.knn_points(a, b, K=2, norm=norm, return_nn=True)
    (out.dists * _t(g)).sum().backward()
    jout = jax_knn_points(jnp.asarray(p1), jnp.asarray(p2), K=2, norm=norm, return_nn=True)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(jout.idx))
    np.testing.assert_array_equal(out.dists.detach().numpy(), np.asarray(jout.dists))
    np.testing.assert_array_equal(out.knn.detach().numpy(), np.asarray(jout.knn))
    assert a.grad.shape == (2, 5, 3) and b.grad.shape == (2, 0, 3)
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(jg1))
    assert float(ref) == 0.0 and not a.grad.any()
