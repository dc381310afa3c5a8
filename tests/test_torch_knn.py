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
from pytorch3d_pointops_tpu.ops.knn import knn_backward as jax_knn_backward
from pytorch3d_pointops_tpu.ops.knn import knn_gather as jax_knn_gather
from pytorch3d_pointops_tpu.ops.knn import knn_points as jax_knn_points
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.kernels import knn as kk
from pytorch3d_pointops_tpu_torch.ops.knn import knn_backward

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
