"""The PyTorch port's deterministic scatter (kernels/scatter.py) against the
JAX package's scatter dispatcher and both of its Pallas scatter kernels, run
in interpret mode at tiny sizes, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels.chamfer_pallas import scatter_add_k1_pallas
from pytorch3d_pointops_tpu.kernels.scatter_pallas import (
    scatter_add_rows as jax_scatter_add_rows,
)
from pytorch3d_pointops_tpu.kernels.scatter_pallas import scatter_add_rows_pallas
from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

torch.set_num_threads(2)
TOL = 1e-5


def _entries(seed, N, E, P2, C):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, P2, size=(N, E))
    contrib = rng.normal(size=(N, E, C)).astype(np.float32)
    return idx, contrib


@pytest.mark.parametrize("N,E,P2,C", [(3, 301, 50, 3), (1, 1, 7, 1), (2, 2049, 40, 8)])
def test_scatter_matches_jax_dispatcher(N, E, P2, C):
    """N > 1, odd E and idx == -1 entries (skipped)."""
    idx, contrib = _entries(N + E, N, E, P2, C)
    ref = jax_scatter_add_rows(jnp.asarray(idx.astype(np.int32)), jnp.asarray(contrib), P2)
    for fn in (ks.scatter_add_rows, ks.scatter_add_k1):
        out = fn(torch.tensor(idx), torch.tensor(contrib), P2)
        assert out.shape == (N, P2, C)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_scatter_matches_rows_pallas_kernel_tail_entries():
    """The banked TPU kernel at a chunk that is not a multiple of its banks
    once dropped tail entries, and failed for N > 1: the port must agree with
    the fixed kernel on exactly those inputs."""
    idx, contrib = _entries(1, 3, 301, 50, 3)
    ref = scatter_add_rows_pallas(
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(contrib), 50,
        chunk=130, banks=4, interpret=True,
    )
    out = ks.scatter_add_rows(torch.tensor(idx), torch.tensor(contrib), 50)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_scatter_matches_k1_pallas_kernel():
    idx, contrib = _entries(2, 2, 77, 30, 3)
    ref = scatter_add_k1_pallas(
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(contrib), 30,
        tile_p1=64, tile_p2=128, interpret=True,
    )
    out = ks.scatter_add_k1(torch.tensor(idx), torch.tensor(contrib), 30)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_segment_plan_sums_bit_equal_to_plain():
    """The kernel's index preparation, summed in its order (ascending entry
    within each target row), reproduces the plain twin bit for bit."""
    idx, contrib = _entries(3, 2, 999, 60, 11)
    idx_t, c_t = torch.tensor(idx), torch.tensor(contrib)
    sorted_keys, order = ks.segment_plan(idx_t, 60)
    assert torch.all(sorted_keys[:, 1:] >= sorted_keys[:, :-1])
    out = torch.zeros((2, 60, 11))
    for n in range(2):
        for pos in range(idx.shape[1]):
            q = int(sorted_keys[n, pos])
            if q < 60:
                out[n, q] = out[n, q] + c_t[n, order[n, pos]]
    ref = ks.scatter_add_plain(idx_t, c_t, 60)
    assert torch.equal(out, ref)
    assert torch.equal(ref, ks.scatter_add_plain(idx_t, c_t, 60))


def test_scatter_launches_or_raises():
    idx = torch.zeros((1, 4), dtype=torch.int64, device="meta")
    contrib = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError):
        ks.scatter_add_rows(idx, contrib, 5)
    with pytest.raises(ValueError):
        ks._launch(torch.zeros((1, 4), dtype=torch.int64), torch.zeros((1, 4, 3)), 5)
    with pytest.raises(ValueError):
        ks.scatter_add_k1(torch.zeros((1, 4), dtype=torch.int64), torch.zeros((1, 5, 3)), 5)
