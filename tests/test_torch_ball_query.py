"""The PyTorch port's ball_query and its kernel module against the JAX
package, on the CPU: the same numpy inputs go through both. Indices must be
equal; distances, gathered points and gradients agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels.ball_query_pallas import ball_query_forward_pallas
from pytorch3d_pointops_tpu.ops.ball_query import ball_query as jax_ball_query
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.kernels import ball_query as kb

torch.set_num_threads(2)
TOL = 1e-5


def _clouds(seed, N, P1, P2, D=3, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        p1 = rng.integers(-4, 5, size=(N, P1, D)).astype(np.float32) / 8
        p2 = rng.integers(-4, 5, size=(N, P2, D)).astype(np.float32) / 8
    else:
        p1 = rng.uniform(-1, 1, size=(N, P1, D)).astype(np.float32)
        p2 = rng.uniform(-1, 1, size=(N, P2, D)).astype(np.float32)
    l1 = rng.integers(1, P1 + 1, size=N)
    l2 = rng.integers(1, P2 + 1, size=N)
    l1[0], l2[0] = P1, P2
    return p1, p2, l1, l2


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _jax(p1, p2, l1, l2, K, radius):
    return jax_ball_query(p1, p2, l1, l2, K=K, radius=radius, impl="xla")


@pytest.mark.parametrize("K,radius", [(1, 0.3), (5, 0.5), (100, 0.9)])
def test_ball_query_matches_jax(K, radius):
    """Ragged lengths on both sides; K=100 exceeds some clouds' lengths2."""
    p1, p2, l1, l2 = _clouds(K, 3, 20, 150)
    l2[2] = 40
    ref = _jax(p1, p2, l1, l2, K, radius)
    out = ppt.ball_query(_t(p1), _t(p2), _t(l1), _t(l2), K=K, radius=radius)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    assert out.idx.dtype == torch.int64
    np.testing.assert_allclose(out.dists.numpy(), np.asarray(ref.dists),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.knn.numpy(), np.asarray(ref.knn),
                               rtol=TOL, atol=TOL)


def test_ball_query_grid_boundary_is_excluded():
    """On a 1/8 grid with radius 0.25, d2 = 0.0625 = r2 exactly on many
    pairs: the test is strict, and the rows agree with JAX bit for bit."""
    p1, p2, l1, l2 = _clouds(1, 2, 30, 200, grid=True)
    ref = _jax(p1, p2, l1, l2, 40, 0.25)
    out = ppt.ball_query(_t(p1), _t(p2), _t(l1), _t(l2), K=40, radius=0.25)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.dists.numpy(), np.asarray(ref.dists))
    d2 = ((p1[:, :, None] - p2[:, None]) ** 2).sum(-1)
    assert (d2 == np.float32(0.0625)).any()
    assert (out.dists.numpy() < 0.0625).all()


def test_ball_query_empty_clouds_and_masked_rows():
    """lengths2 = 0 gives all padding; rows past lengths1 are padding."""
    p1, p2, _, _ = _clouds(2, 2, 10, 30)
    l1, l2 = np.array([4, 10]), np.array([30, 0])
    ref = _jax(p1, p2, l1, l2, 6, 2.0)
    out = ppt.ball_query(_t(p1), _t(p2), _t(l1), _t(l2), K=6, radius=2.0)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    assert (out.idx.numpy()[0, 4:] == -1).all() and (out.idx.numpy()[1] == -1).all()
    assert (out.dists.numpy()[out.idx.numpy() < 0] == 0).all()
    assert (out.knn.numpy()[out.idx.numpy() < 0] == 0).all()


def test_ball_query_wide_points_match_pallas_and_jax():
    """D=16: the port sums axis by axis, as the TPU kernel does (exact), and
    the JAX XLA path takes a matrix product (equal away from the boundary)."""
    p1, p2, l1, l2 = _clouds(3, 2, 16, 120, D=16)
    r2 = kb.squared_radius(2.6)
    idx_pal = ball_query_forward_pallas(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2), K=20, radius=2.6,
        tile_p1=16, tile_p2=256, interpret=True,
    )
    full = np.full(2, 16)
    _, idx = kb.ball_query_points(_t(p1), _t(p2), _t(full), _t(l2), 20, r2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_pal))
    assert (idx.numpy() >= 0).sum() > 20
    ref = _jax(p1, p2, l1, l2, 20, 2.6)
    out = ppt.ball_query(_t(p1), _t(p2), _t(l1), _t(l2), K=20, radius=2.6)
    d2 = ((p1[:, :, None] - p2[:, None]) ** 2).sum(-1)
    assert np.abs(d2 - r2).min() > 1e-4  # no pair near the boundary
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(out.dists.numpy(), np.asarray(ref.dists),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("K", [6, 100])
def test_kernel_module_matches_pallas_kernel(K):
    """The kernel module's plain twin against the TPU kernel in interpret
    mode at tiny tiles; K=100 > 64 runs the TPU kernel's chained rounds."""
    p1, p2, _, l2 = _clouds(4 + K, 2, 40, 900)
    radius = 1.0 if K == 6 else 1.5
    idx_pal = ball_query_forward_pallas(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2), K=K, radius=radius,
        tile_p1=16, tile_p2=256, interpret=True,
    )
    full = np.full(2, 40)
    d, idx = kb.ball_query_points(_t(p1), _t(p2), _t(full), _t(l2), K,
                                  kb.squared_radius(radius))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_pal))
    if K > 64:  # some query holds more than one TPU round of hits
        assert (idx.numpy()[..., 64:] >= 0).any()
    ref =np.where(idx.numpy() >= 0, ((p1[:, :, None] - np.take_along_axis(
        p2[:, None], np.maximum(idx.numpy(), 0)[..., None], axis=2)) ** 2).sum(-1), 0)
    np.testing.assert_allclose(d.numpy(), ref, rtol=TOL, atol=TOL)


def test_plain_twin_streamed_equals_full(monkeypatch):
    """The P2-tiled plain version (large problems) merges tiles in scan
    order: the same result as the single-shot matrix."""
    p1, p2, l1, l2 = _clouds(5, 2, 30, 1000)
    args = (_t(p1), _t(p2), _t(l1), _t(l2))
    r2 = kb.squared_radius(0.7)
    full = kb.ball_query_plain(*args, 70, r2)
    monkeypatch.setattr(kb, "_FULL_MATRIX_MAX_ELEMS", 0)
    monkeypatch.setattr(kb, "_TILE_P2", 128)
    tiled = kb.ball_query_plain(*args, 70, r2)
    assert torch.equal(full[1], tiled[1]) and torch.equal(full[0], tiled[0])
    assert (full[1] >= 0).sum(-1).max() > 20


def test_squared_radius_rounds_once():
    """r2 is radius*radius in double, rounded to float32 once, as JAX forms
    it; squaring an already rounded radius in float32 may differ."""
    for r in (0.2, 0.25, 0.1, 1.3, 0.7):
        assert kb.squared_radius(r) == float(jnp.float32(r * r))
    assert kb.squared_radius(0.25) == 0.0625


def test_ball_query_backward_matches_jax():
    p1, p2, l1, l2 = _clouds(6, 2, 12, 40)
    w = np.random.default_rng(1).normal(size=(2, 12, 5)).astype(np.float32)
    g1, g2 = jax.grad(
        lambda a, b: jnp.sum(w * _jax(a, b, l1, l2, 5, 0.8).dists), argnums=(0, 1)
    )(jnp.asarray(p1), jnp.asarray(p2))
    t1 = _t(p1, requires_grad=True)
    t2 = _t(p2, requires_grad=True)
    out = ppt.ball_query(t1, t2, _t(l1), _t(l2), K=5, radius=0.8, return_nn=False)
    assert out.knn is None
    (out.dists * _t(w)).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(g2), rtol=TOL, atol=TOL)


def test_ball_query_gradient_through_knn_matches_jax():
    """The gathered neighbours carry gradient to p2 through masked_gather."""
    p1, p2, l1, l2 = _clouds(7, 2, 10, 30)
    w = np.random.default_rng(2).normal(size=(2, 10, 4, 3)).astype(np.float32)
    g2 = jax.grad(lambda b: jnp.sum(w * _jax(p1, b, l1, l2, 4, 0.9).knn))(
        jnp.asarray(p2)
    )
    t2 = _t(p2, requires_grad=True)
    out = ppt.ball_query(_t(p1), t2, _t(l1), _t(l2), K=4, radius=0.9)
    (out.knn * _t(w)).sum().backward()
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(g2), rtol=TOL, atol=TOL)


def test_ball_query_defaults_and_errors():
    p1, p2, _, _ = _clouds(8, 1, 8, 12)
    ref = jax_ball_query(p1, p2, impl="xla")
    out = ppt.ball_query(_t(p1), _t(p2))
    assert out.idx.shape == (1, 8, 500)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    with pytest.raises(ValueError):
        ppt.ball_query(_t(p1), _t(p2[..., :2]))
    with pytest.raises(ValueError):
        ppt.ball_query(_t(p1), _t(np.concatenate([p2, p2])))


def test_wrappers_launch_or_raise():
    """A tensor that is neither CPU nor CUDA raises, and the CUDA wrapper
    refuses CPU tensors instead of running the plain version."""
    p = torch.zeros((1, 4, 3), device="meta")
    lengths = torch.zeros((1,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kb.ball_query_points(p, p, lengths, lengths, 2, 0.04)
    cpu_len = torch.full((1,), 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        kb.ball_query_cuda(torch.zeros((1, 4, 3)), torch.zeros((1, 4, 3)),
                           cpu_len, cpu_len, 2, 0.04)
