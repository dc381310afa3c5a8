"""The PyTorch port's deterministic scatter (kernels/scatter.py) against the
JAX package's scatter dispatcher and both of its Pallas scatter kernels, run
in interpret mode at tiny sizes, on the CPU; the model of the order in
which the kernels add the entries (bucket_order_plain: the partition into
buckets of rows, then each bucket's chunks ordered by row) against the
stable argsort of the targets, the order in which the plain twin sums; and
the routing (scatter_plan)."""

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


def _segment_plan(idx, P2):
    """Each cloud's entries sorted by target (skipped entries keyed P2, after
    every real target), stably, so equal targets keep ascending entry
    order: (sorted_keys, order), both (N, E) int64."""
    keys = torch.where(idx >= 0, idx, P2)
    order = torch.argsort(keys, dim=1, stable=True)
    return torch.gather(keys, 1, order), order


def _segment_plan_flat(idx, P2):
    """``_segment_plan`` as flat keys n * P2 + target and entry ids n * E +
    j: every cloud's targeted entries, then every skipped entry (key
    N * P2), each in that order."""
    N, E = idx.shape
    sorted_keys, order = _segment_plan(idx, P2)
    valid = sorted_keys < P2
    keys = torch.where(valid, sorted_keys + torch.arange(N)[:, None] * P2, N * P2)
    ids = order + torch.arange(N)[:, None] * E
    return torch.cat([keys[valid], keys[~valid]]), torch.cat([ids[valid], ids[~valid]])


def test_segment_plan_sums_bit_equal_to_plain():
    """The entries summed in the stable order of their targets (ascending
    entry within each target row), as the kernels sum them, reproduce the
    plain twin bit for bit."""
    idx, contrib = _entries(3, 2, 999, 60, 11)
    idx_t, c_t = torch.tensor(idx), torch.tensor(contrib)
    sorted_keys, order = _segment_plan(idx_t, 60)
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
    # The most rows the keys take: buckets of 2^10 rows, two passes of the
    # 21 bits above them.
    assert ks.scatter_plan(1, 1, 2**31 - 2, 3) == ks.Plan(10, 2, 11, 3)
    with pytest.raises(ValueError):
        ks.scatter_plan(1, 1, 2**31 - 1, 3)
    with pytest.raises(ValueError):
        ks.check_limits(1, 2**31, 1)


def _case_entries(seed, N, E, P2, C, kind):
    """idx and contrib for a case: "uniform" targets over [-1, P2); "hub",
    four fifths of the entries on one row; "one row", every entry on one
    row; "skipped", every entry skipped."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, P2, size=(N, E))
    if kind == "hub":
        idx[rng.uniform(size=(N, E)) < 0.8] = 11
    elif kind == "one row":
        idx[:] = 3
    elif kind == "skipped":
        idx[:] = -1
    return idx, rng.normal(size=(N, E, C)).astype(np.float32)


# (N, E, P2, C, targets, plan the shape takes: "direct" or partition passes)
CASES = [
    (2, 1500, 5000, 3, "hub", 1),        # one row takes most entries
    (1, 5000, 300, 3, "one row", "direct"),
    (1, 20000, 300, 3, "one row", 1),    # one bucket of ten chunks
    (3, 400, 2000, 3, "skipped", 1),     # every entry skipped
    (1, 200, 50000, 3, "uniform", 1),    # most of 196 buckets empty
    (2, 700, 1000, 3, "uniform", "direct"),  # N * P2 within one bucket
    (2, 1000, 3000, 1, "uniform", 1),
    (2, 1000, 3000, 8, "uniform", 1),
    (2, 1000, 3000, 33, "uniform", 1),   # channels in groups of 7
    (1, 3000, 2**22 + 5, 2, "uniform", 2),  # two partition passes
]


@pytest.mark.parametrize("N,E,P2,C,kind,route", CASES)
def test_scatter_cases_match_jax_dispatcher(N, E, P2, C, kind, route):
    """Both entry points (on the CPU, the plain twin that the kernels
    reproduce bit for bit) against the JAX dispatcher, and from run to
    run."""
    idx, contrib = _case_entries(N * E + P2 + C, N, E, P2, C, kind)
    plan = ks.scatter_plan(N, E, P2, C)
    assert (plan.passes == 0) if route == "direct" else (plan.passes == route)
    ref = np.asarray(jax_scatter_add_rows(jnp.asarray(idx.astype(np.int32)),
                                          jnp.asarray(contrib), P2))
    idx_t, c_t = torch.tensor(idx), torch.tensor(contrib)
    plain = ks.scatter_add_plain(idx_t, c_t, P2)
    assert torch.equal(plain, ks.scatter_add_plain(idx_t, c_t, P2))
    for out in (plain, ks.scatter_add_rows(idx_t, c_t, P2),
                ks.scatter_add_k1(idx_t, c_t, P2)):
        assert out.shape == (N, P2, C)
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_scatter_matches_rows_pallas_kernel_on_a_hub():
    """The plain twin, whose sums the kernels reproduce bit for bit, against
    the TPU kernel in interpret mode, on entries most of which share one
    row."""
    idx, contrib = _case_entries(5, 2, 300, 40, 3, "hub")
    ref = scatter_add_rows_pallas(
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(contrib), 40,
        chunk=128, banks=4, interpret=True,
    )
    out = ks.scatter_add_rows(torch.tensor(idx), torch.tensor(contrib), 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("N,E,P2,C,kind,route", CASES)
def test_bucket_order_matches_segment_plan(N, E, P2, C, kind, route):
    """The partition leaves the entries ordered by bucket (key >> shift),
    stably; the chunks then add each row's entries in ascending entry
    order: reordered by key, stably, the kernels' order is exactly the
    stable argsort's."""
    idx = torch.tensor(_case_entries(N + E + P2, N, E, P2, C, kind)[0])
    plan = ks.scatter_plan(N, E, P2, C)
    keys = ks._flat_keys(idx, P2)
    if plan.passes:
        part_keys, part_vals = ks._radix_passes(keys, torch.arange(N * E), plan.shift,
                                                plan.passes, plan.width)
        by_bucket = torch.argsort(keys >> plan.shift, stable=True)
        assert torch.equal(part_vals, by_bucket)
        assert torch.equal(part_keys, keys[by_bucket])
    _hold_bucket_order(idx, P2, plan)


def _hold_bucket_order(idx, P2, plan):
    """``bucket_order_plain`` under ``plan`` takes every entry once and,
    reordered by key stably, is exactly ``_segment_plan``'s order: each
    row's entries in ascending entry order."""
    N, E = idx.shape
    order_keys, order_vals = ks.bucket_order_plain(idx, P2, plan)
    assert torch.equal(torch.sort(order_vals).values, torch.arange(N * E))
    by_key = torch.argsort(order_keys, stable=True)
    ref_keys, ref_vals = _segment_plan_flat(idx, P2)
    assert torch.equal(order_keys[by_key], ref_keys)
    assert torch.equal(order_vals[by_key], ref_vals)


@pytest.mark.parametrize("shift", range(ks._MAX_BUCKET_BITS + 1))
def test_bucket_order_under_every_bucket_size(shift):
    """A skewed input (every second entry on one row) under every bucket
    size a plan can force, as the card's check runs it: from one row a
    bucket (the partition a full sort of the keys, in two passes) to 2^11
    rows, each in as many passes of at most 11 bits as the bits above
    ``shift`` need."""
    P2 = 100_000
    idx = torch.tensor(_case_entries(shift, 1, 3000, P2, 1, "uniform")[0])
    idx[0, ::2] = 7
    digit_bits = P2.bit_length() - shift
    passes = -(-digit_bits // ks._MAX_DIGIT_BITS)
    plan = ks.Plan(shift, passes, -(-digit_bits // passes), 3)
    keys = ks._flat_keys(idx, P2)
    part_keys, part_vals = ks._radix_passes(keys, torch.arange(idx.numel()), shift,
                                            passes, plan.width)
    by_bucket = torch.argsort(keys >> shift, stable=True)
    assert torch.equal(part_vals, by_bucket) and torch.equal(part_keys, keys[by_bucket])
    _hold_bucket_order(idx, P2, plan)


@pytest.mark.parametrize("N,E,P2,C,plan", [
    (2, 8000, 800, 3, ks.Plan(3, 1, 8, 3)),            # config 1: past one block
    (1, 8000, 800, 3, ks.Plan(10, 0, 0, 3)),           # one of its clouds: one launch
    (1, 1_600_000, 100_000, 3, ks.Plan(9, 1, 8, 3)),   # north star: 196 buckets
    (16, 10_000, 10_000, 3, ks.Plan(10, 1, 8, 3)),     # config 3 K=1
    (32, 16_384, 4_096, 3, ks.Plan(10, 1, 8, 3)),      # config 2 ball gather
    (1, 16_000_000, 1_000_000, 3, ks.Plan(10, 1, 10, 3)),  # config 4
    (1, 20_000, 2_048, 3, ks.Plan(4, 1, 8, 3)),        # too many entries for one block
    (1, 8_192, 1_792, 3, ks.Plan(11, 0, 0, 3)),        # one block up to 8,192 entries
    (1, 8_193, 1_792, 3, ks.Plan(3, 1, 8, 3)),
    (1, 8_192, 1_793, 3, ks.Plan(3, 1, 8, 3)),         # past 1,792 rows: 4,096 entries
    (1, 4_096, 2_048, 3, ks.Plan(12, 0, 0, 3)),
    (1, 4_097, 2_048, 3, ks.Plan(4, 1, 8, 3)),
    (1, 100, 300, 3, ks.Plan(9, 0, 0, 3)),
    (1, 100, 2**22, 3, ks.Plan(10, 2, 7, 3)),          # 2^22 rows: two passes
    (1, 100, 5, 33, ks.Plan(3, 0, 0, 7)),              # 33 channels in 5 groups of 7
    (1, 100, 5, 9, ks.Plan(3, 0, 0, 5)),
    (0, 0, 5, 0, ks.Plan(1, 0, 0, 1)),                 # nothing to do
])
def test_scatter_plan_routes(N, E, P2, C, plan):
    assert ks.scatter_plan(N, E, P2, C) == plan
    assert len(ks.step_names(plan)) == (1 if plan.passes == 0 else plan.passes + 3)
