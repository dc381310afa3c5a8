"""The PyTorch port's Morton codes and sorts against the JAX package, on the
CPU: the same numpy points (with runs of duplicated points) give bit-equal
codes for D in {1, 2, 3, 5}, on the per-cloud box and on an explicit joint
box, the same stable order, and an inverse that round-trips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels.spatial_sort import morton_argsort as jax_argsort
from pytorch3d_pointops_tpu.kernels.spatial_sort import morton_code as jax_code
from pytorch3d_pointops_tpu_torch.kernels import spatial_sort as ss

torch.set_num_threads(2)


def _points(seed, N, P, D, scale=1.0):
    rng = np.random.default_rng(seed)
    p = (scale * rng.normal(size=(N, P, D))).astype(np.float32)
    p[:, 50:60] = p[:, 40:50]  # duplicate coordinate runs
    p[:, 70:75] = p[:, 3:4]
    return p


@pytest.mark.parametrize("D", [1, 2, 3, 5])
def test_morton_code_bit_equal_to_jax(D):
    p = _points(D, 2, 200, D)
    ours = ss.morton_code(torch.from_numpy(p))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_code(jnp.asarray(p))))
    # A joint box (what candidate sorting uses) wider than the cloud.
    lo = p.min(axis=1, keepdims=True) - np.float32(0.37)
    hi = p.max(axis=1, keepdims=True) * np.float32(1.5) + np.float32(0.1)
    ours = ss.morton_code(torch.from_numpy(p), torch.from_numpy(lo), torch.from_numpy(hi))
    ref = jax_code(jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_morton_code_degenerate_and_clipped():
    """A cloud whose points all coincide (a zero box) codes to 0; points
    outside an explicit box clip to its faces; every code is below
    PAD_CODE."""
    same = np.full((1, 9, 3), 0.25, np.float32)
    assert (ss.morton_code(torch.from_numpy(same)) == 0).all()
    p = _points(7, 1, 100, 3, scale=4.0)
    lo, hi = np.full((1, 1, 3), -1, np.float32), np.full((1, 1, 3), 1, np.float32)
    ours = ss.morton_code(*(torch.from_numpy(a) for a in (p, lo, hi)))
    ref = jax_code(jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(ours.max()) == (1 << 30) - 1 and int(ours.max()) < ss.PAD_CODE


@pytest.mark.parametrize("D", [2, 3, 5])
def test_morton_argsort_matches_jax_and_round_trips(D):
    p = _points(10 + D, 2, 200, D)
    order, inverse = ss.morton_argsort(torch.from_numpy(p))
    jorder, _ = jax_argsort(jnp.asarray(p))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    tp = torch.from_numpy(p)
    ps = torch.gather(tp, 1, order[..., None].expand_as(tp))
    back = torch.gather(ps, 1, inverse[..., None].expand_as(tp))
    assert torch.equal(back, tp)
    codes = ss.morton_code(ps)
    assert (codes[:, 1:] >= codes[:, :-1]).all()
    for n in range(2):
        assert sorted(order[n].tolist()) == list(range(200))
        assert torch.equal(inverse[n][order[n]], torch.arange(200))
