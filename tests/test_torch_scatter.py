"""The PyTorch port's deterministic scatter (kernels/scatter.py) against the
JAX package's scatter dispatcher and both of its Pallas scatter kernels, run
in interpret mode at tiny sizes, on the CPU; and the radix sort's digit
logic (radix_plan_plain) against the stable argsort it replaces."""

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


def _hub_entries(seed, N, E, P2, skip_all):
    """Half the entries on 16 targets spread over [0, P2) (long runs of equal
    keys in every digit), the rest uniform over [-1, P2)."""
    rng = np.random.default_rng(seed)
    if skip_all:
        return torch.full((N, E), -1, dtype=torch.int64)
    hubs = rng.integers(0, P2, size=16)
    idx = np.where(rng.uniform(size=(N, E)) < 0.5, rng.choice(hubs, size=(N, E)),
                   rng.integers(-1, P2, size=(N, E)))
    return torch.tensor(idx, dtype=torch.int64)


@pytest.mark.parametrize("N,E,P2,passes,skip_all", [
    (3, 301, 50, 1, False),          # N > 1, skipped entries
    (2, 1, 7, 1, False),             # E = 1
    (2, 40, 9, 1, True),             # every entry skipped
    (1, 700, 2**11 - 1, 1, False),   # N * P2 = 2^11 - 1: one 11-bit pass
    (2, 350, 2**10, 2, False),       # N * P2 = 2^11: two passes
    (1, 500, 2**22 - 1, 2, False),   # N * P2 = 2^22 - 1: two 11-bit passes
    (2, 300, 2**21, 3, False),       # N * P2 = 2^22: three passes
])
def test_radix_plan_matches_segment_plan(N, E, P2, passes, skip_all):
    """The kernel's flat keys, digit widths and passes, each a stable
    counting sort, give exactly the stable argsort's keys and order."""
    assert ks.radix_digits(N, E, P2)[0] == passes
    idx = _hub_entries(N * E + P2, N, E, P2, skip_all)
    keys, order = ks.radix_plan_plain(idx, P2)
    ref_keys, ref_order = ks.segment_plan(idx, P2)
    assert torch.equal(keys, ref_keys)
    assert torch.equal(order, ref_order)
    assert torch.equal(ks.sort_plan(idx, P2)[1], ref_order)


def test_scatter_past_int31_raises_on_any_device():
    """N * P2 + 1 buckets or N * E entries past 2^31 - 1 do not fit the
    kernel's 32-bit keys: the wrappers raise before any launch."""
    small = torch.zeros((2, 4), dtype=torch.int64, device="meta")
    wide = torch.zeros((2, 2**30), dtype=torch.int64, device="meta")
    for idx, P2 in ((small, 2**30), (wide, 8)):
        contrib = torch.zeros((*idx.shape, 3), device="meta")
        for fn in (ks.scatter_add_rows, ks.scatter_add_k1):
            with pytest.raises(ValueError, match="2\\^31"):
                fn(idx, contrib, P2)
        with pytest.raises(ValueError, match="2\\^31"):
            ks.sort_plan(idx, P2)
    assert ks.radix_digits(1, 1, 2**31 - 2) == (3, 11)
    with pytest.raises(ValueError):
        ks.radix_digits(1, 1, 2**31 - 1)
