"""The PyTorch port's farthest point sampling and its kernel module against
the JAX package, on the CPU: the same numpy inputs go through both. Indices
must be equal; sampled points and gradients agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels.fps_pallas import (
    fps_pallas,
    fps_pallas_batched,
    fps_pallas_chunked,
)
from pytorch3d_pointops_tpu.ops.fps import _fps_single
from pytorch3d_pointops_tpu.ops.fps import sample_farthest_points as jax_fps
from pytorch3d_pointops_tpu.ops.fps import (
    sample_farthest_points_naive as jax_fps_naive,
)
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.kernels import fps as kf
from pytorch3d_pointops_tpu_torch.ops import fps as ofps

torch.set_num_threads(2)
TOL = 1e-5


def _points(seed, N, P, D=3, grid=False):
    rng = np.random.default_rng(seed)
    if grid:  # few distinct values: many exact distance ties
        return rng.integers(0, 3, size=(N, P, D)).astype(np.float32) / 8
    return rng.normal(size=(N, P, D)).astype(np.float32)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _xla_idx(pts, lengths, K, starts, max_K):
    return np.asarray(jax.vmap(lambda p, l, k, s: _fps_single(p, l, k, s, max_K))(
        jnp.asarray(pts), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(K, jnp.int32), jnp.asarray(starts, jnp.int32),
    ))


# Ragged lengths, a cloud of length 0, per-cloud K with K > length, and
# explicit starts; the same inputs for every entry point.
_LENGTHS = np.array([60, 33, 0, 7, 60])
_K = np.array([12, 12, 5, 12, 1])
_STARTS = np.array([0, 3, 0, 6, 59])


@pytest.mark.parametrize("grid", [False, True])
def test_fps_batched_matches_pallas_kernel(grid):
    pts = _points(1 + grid, 5, 60, grid=grid)
    ref = fps_pallas_batched(jnp.asarray(pts), jnp.asarray(_LENGTHS), jnp.asarray(_K),
                             jnp.asarray(_STARTS), 12, interpret=True)
    out = kf.fps_batched(_t(pts), _t(_LENGTHS), _t(_K), _t(_STARTS), 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.dtype == torch.int64


@pytest.mark.parametrize("grid", [False, True])
def test_fps_resident_matches_pallas_kernel(grid):
    """The TPU kernel's dense8 packing pads P=1500 to 2048 points."""
    pts = _points(3 + grid, 2, 1500, grid=grid)
    lengths, K, starts = np.array([1500, 1200]), np.array([40, 25]), np.array([0, 1199])
    ref = fps_pallas(jnp.asarray(pts), jnp.asarray(lengths), jnp.asarray(K),
                     jnp.asarray(starts), 40, interpret=True)
    out = kf.fps_resident(_t(pts), _t(lengths), _t(K), _t(starts), 40)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("grid", [False, True])
def test_fps_streaming_matches_pallas_kernel(grid):
    """Small chunks: the TPU kernel's argmax ties straddle chunk edges."""
    pts = _points(5 + grid, 2, 2600, grid=grid)
    lengths, K, starts = np.array([2600, 2100]), np.array([25, 13]), np.array([0, 7])
    ref = fps_pallas_chunked(jnp.asarray(pts), jnp.asarray(lengths), jnp.asarray(K),
                             jnp.asarray(starts), 25, chunk_points=1024,
                             interpret=True)
    out = kf.fps_streaming(_t(pts), _t(lengths), _t(K), _t(starts), 25)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("D", [3, 16])
@pytest.mark.parametrize("grid", [False, True])
def test_kernel_module_matches_xla_loop(D, grid):
    """Every entry point against the JAX package's per-cloud loop, with K
    larger than the number of distinct grid points (all-zero rounds pick the
    first point, selected or not)."""
    pts = _points(7 + D + grid, 5, 60, D=D, grid=grid)
    K = np.array([40, 12, 5, 12, 1]) if grid else _K
    ref = _xla_idx(pts, _LENGTHS, K, _STARTS, int(K.max()))
    for fn in (kf.fps_batched, kf.fps_resident, kf.fps_streaming):
        out = fn(_t(pts), _t(_LENGTHS), _t(K), _t(_STARTS), int(K.max()))
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("K", [1, 10, [3, 30, 8, 4]])
def test_sample_farthest_points_matches_jax(K):
    pts = _points(11, 4, 50)
    lengths = np.array([50, 20, 0, 3])
    ref_pts, ref_idx = jax_fps(pts, lengths, K, impl="xla")
    out_pts, out_idx = ppt.sample_farthest_points(_t(pts), _t(lengths), K)
    np.testing.assert_array_equal(out_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(out_pts.numpy(), np.asarray(ref_pts), rtol=TOL, atol=TOL)
    assert out_idx.dtype == torch.int64


def test_sample_farthest_points_grid_ties_and_k_tensor():
    pts = _points(12, 3, 40, grid=True)
    lengths = np.array([40, 40, 9])
    K = np.array([30, 4, 20])  # more than the 27 distinct points
    ref_pts, ref_idx = jax_fps(pts, lengths, K, impl="xla")
    out_pts, out_idx = ppt.sample_farthest_points(_t(pts), _t(lengths), _t(K))
    np.testing.assert_array_equal(out_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(out_pts.numpy(), np.asarray(ref_pts))


def test_naive_oracle_matches_jax_naive_and_the_op():
    pts = _points(13, 4, 64)
    lengths = np.array([64, 40, 0, 2])
    _, ref_idx = jax_fps_naive(pts, lengths, 16)
    naive_pts, naive_idx = ppt.sample_farthest_points_naive(_t(pts), _t(lengths), 16)
    op_pts, op_idx = ppt.sample_farthest_points(_t(pts), _t(lengths), 16)
    np.testing.assert_array_equal(naive_idx.numpy(), np.asarray(ref_idx))
    assert torch.equal(naive_idx, op_idx) and torch.equal(naive_pts, op_pts)


def test_random_start():
    """Starts are floor(u * max(length, 1)) clipped to length - 1, with u
    from the generator; without a generator the op raises."""
    pts = _points(14, 4, 30)
    lengths = np.array([30, 10, 1, 0])
    gen = torch.Generator().manual_seed(7)
    u = torch.rand((4,), generator=torch.Generator().manual_seed(7)).numpy()
    expect = np.minimum(np.floor(u * np.maximum(lengths, 1)).astype(np.int64),
                        np.maximum(lengths - 1, 0))
    _, idx = ppt.sample_farthest_points(_t(pts), _t(lengths), 5,
                                        random_start_point=True, generator=gen)
    np.testing.assert_array_equal(idx.numpy()[:3, 0], expect[:3])
    assert idx[3, 0] == -1
    ref = _xla_idx(pts, lengths, np.full(4, 5), expect, 5)
    np.testing.assert_array_equal(idx.numpy(), ref)
    _, naive_idx = ppt.sample_farthest_points_naive(
        _t(pts), _t(lengths), 5, random_start_point=True,
        generator=torch.Generator().manual_seed(7),
    )
    assert torch.equal(naive_idx, idx)
    with pytest.raises(ValueError):
        ppt.sample_farthest_points(_t(pts), _t(lengths), 5, random_start_point=True)
    with pytest.raises(ValueError):
        ppt.sample_farthest_points_naive(_t(pts), _t(lengths), 5,
                                         random_start_point=True)


def test_sampled_points_gradient_matches_jax():
    """The selection carries no gradient; the sampled points do, through
    masked_gather."""
    pts = _points(15, 2, 25)
    lengths = np.array([25, 6])
    w = np.random.default_rng(3).normal(size=(2, 8, 3)).astype(np.float32)
    g = jax.grad(lambda p: jnp.sum(w * jax_fps(p, lengths, 8, impl="xla")[0]))(
        jnp.asarray(pts)
    )
    tp = _t(pts, requires_grad=True)
    sampled, idx = ppt.sample_farthest_points(tp, _t(lengths), 8)
    assert not idx.requires_grad
    (sampled * _t(w)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g), rtol=TOL, atol=TOL)


def test_edge_shapes_and_errors():
    pts = _points(16, 2, 10)
    _, idx = ppt.sample_farthest_points(_t(pts), None, 0)
    assert idx.shape == (2, 0)
    _, idx = ppt.sample_farthest_points(_t(pts), None, [0, 3])
    np.testing.assert_array_equal(idx.numpy()[0], [-1, -1, -1])
    with pytest.raises(ValueError):
        ppt.sample_farthest_points(_t(pts), None, [1, 2, 3])
    with pytest.raises(ValueError):
        ppt.sample_farthest_points(_t(pts), _t(np.array([10, 10, 10])), 3)


def test_route_and_wrappers_launch_or_raise():
    """On the CPU every route runs the plain twin; a tensor that is neither
    CPU nor CUDA raises, and no CPU tensor reaches a kernel."""
    assert ofps._route(torch.zeros((2, 10, 3))) is kf.fps_batched
    meta = torch.zeros((1, 4, 3), device="meta")
    ml = torch.zeros((1,), dtype=torch.int64, device="meta")
    for fn in (kf.fps_batched, kf.fps_resident, kf.fps_streaming):
        with pytest.raises(ValueError):
            fn(meta, ml, ml, ml, 2)
    one = torch.ones((1,), dtype=torch.int64)
    with pytest.raises(ValueError):
        kf._launch("block", torch.zeros((1, 4, 3)), one, one, one, 2)
