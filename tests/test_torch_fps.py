"""The PyTorch port's farthest point sampling and its kernel module against
the JAX package, on the CPU: the same numpy inputs go through both. Indices
must be equal; sampled points and gradients agree to 1e-5."""

import types

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


def test_k_given_on_the_host_is_not_read_back():
    """An int, list, tuple or numpy K takes its maximum on the host before
    the copy: no ``sync.fps.max_k``, and the indices of a K given as a
    tensor, which is still read back once."""
    from pytorch3d_pointops_tpu_torch import tracing

    pts = torch.from_numpy(_points(3, 4, 700))
    lengths = torch.tensor([700, 650, 600, 512])
    tracing.clear()
    _, want = ppt.sample_farthest_points(pts, lengths, K=torch.full((4,), 512))
    assert tracing.counts("sync.") == {"sync.fps.max_k": 1}
    for K in (512, np.int64(512), [512] * 4, (512,) * 4, np.full(4, 512)):
        tracing.clear()
        _, idx = ppt.sample_farthest_points(pts, lengths, K=K)
        assert tracing.counts("sync.") == {}, K
        assert torch.equal(idx, want), K
    tracing.clear()


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


# An H100 SXM: 132 SMs, 227 KB of shared memory a block less the 1 KB the
# FPS kernels keep for static arrays, and the clusters of each cluster
# instance it holds at once (cudaOccupancyMaxActiveClusters on the card).
_SMS, _SMEM = 132, 232448 - 1024
_ACTIVE = {(256, 16, 2): 132, (256, 16, 4): 62, (256, 16, 8): 30, (256, 16, 16): 14,
           (512, 16, 2): 66, (512, 16, 4): 30, (512, 16, 8): 15, (512, 16, 16): 7,
           (1024, 16, 2): 66, (1024, 16, 4): 30, (1024, 16, 8): 15, (1024, 16, 16): 7}


def _caps(D):
    """(resident, register) capacities of the whole grid, in points."""
    res, reg = kf._grid_caps(D, _SMEM)
    return _SMS * res, _SMS * reg


_EDGES = ("res-1", "res", "res+1", "reg-1", "reg", "reg+1", "one", "6M")


def _edge_P(D, edge):
    res, reg = _caps(D)
    return {"res-1": res - 1, "res": res, "res+1": res + 1, "reg-1": reg - 1,
            "reg": reg, "reg+1": reg + 1, "one": 1, "6M": 6_000_000}[edge]


def _check_plan(P, D, plan):
    """The blocks' slices tile [0, P) in order; within a slice, slot s of
    thread t is point s * threads + t, so a thread's points ascend and the
    block's threads visit each point of its slice once; the slots hold the
    slice; resident plus streamed is the slice; the shared memory stays
    within the budget."""
    assert plan.blocks == _SMS and plan.slice == -(-P // _SMS)
    assert plan.threads in (256, 512, 1024) and plan.threads % 32 == 0
    assert -(-_SMS // 32) <= plan.threads // 32  # a lane for each record
    starts = np.minimum(np.arange(plan.blocks) * plan.slice, P)
    ends = np.minimum(starts + plan.slice, P)
    assert starts[0] == 0 and ends[-1] == P
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    S = -(-plan.slice // plan.threads)
    for b in {0, int(np.searchsorted(ends, P))}:
        cnt = int(ends[b] - starts[b])
        q = np.arange(S)[:, None] * plan.threads + np.arange(plan.threads)[None, :]
        assert (np.diff(q, axis=0) > 0).all()
        np.testing.assert_array_equal(np.sort(q[q < cnt]), np.arange(cnt))
    assert plan.slots == 0 or plan.slots >= S
    assert plan.resident + plan.streamed == plan.slice and plan.resident >= 0
    assert plan.smem_bytes == 4 * D * (plan.smem_slots * plan.threads + 1)
    assert plan.smem_bytes <= _SMEM and plan.smem_slots <= max(S, plan.slots)
    in_regs = (D == 3 and plan.slots > 0
               and (D + 1) * plan.slots * plan.threads <= 32768)  # csrc reg_coords
    if in_regs:
        assert (plan.threads, plan.slots) in kf.REG_PLANS
        assert plan.smem_slots == S and plan.streamed == 0
    else:
        assert plan.threads == kf.GRID_THREADS
        assert plan.slots in kf.SLOTS + (0,)
        assert plan.resident == min(plan.slice, plan.smem_slots * plan.threads)
        # At D=3 every slot's coordinates in shared memory where they fit.
        fit = kf._smem_slots(D, _SMEM, plan.threads)
        all_fit = D == 3 and 0 < plan.slots <= fit
        assert plan.smem_slots == (plan.slots if all_fit else min(S, fit))
    assert plan.tier == ("global" if plan.slots == 0 else
                         "registers" if plan.streamed else "resident")


@pytest.mark.parametrize("D", [1, 3, 16])
@pytest.mark.parametrize("edge", _EDGES)
def test_grid_plan_covers_each_point_once(D, edge):
    """At and around each capacity of the grid kernel's plan."""
    P = _edge_P(D, edge)
    _check_plan(P, D, kf._grid_plan(1, P, D, _SMS, _SMEM))


@pytest.mark.parametrize("P", [8 * _SMS, 2048 * _SMS, 2048 * _SMS + 1,
                               8192 * _SMS, 8192 * _SMS + 1])
def test_grid_plan_register_coordinates(P):
    """At D=3 slices of up to 2048 points take 256 threads with 8 slots,
    up to 8192 points 512 threads with 16, both with coordinates in
    registers; past that 1024 threads with coordinates in shared memory."""
    plan = kf._grid_plan(1, P, 3, _SMS, _SMEM)
    _check_plan(P, 3, plan)
    slice_ = -(-P // _SMS)
    want = (256, 8) if slice_ <= 2048 else (512, 16) if slice_ <= 8192 else (1024, 16)
    assert (plan.threads, plan.slots) == want and plan.tier == "resident"


@pytest.mark.parametrize("D", [1, 3, 16])
def test_grid_plan_tiers_change_at_the_capacities(D, monkeypatch):
    res, reg = _caps(D)
    tier = lambda P: kf._grid_plan(1, P, D, _SMS, _SMEM).tier  # noqa: E731
    assert tier(1) == tier(res) == "resident"
    assert tier(res + 1) == ("registers" if reg > res else "global")
    if reg > res:
        assert tier(reg - 1) == tier(reg) == "registers"
    assert tier(reg + 1) == tier(6_000_000) == "global"
    # The resident cap: whole slots of 1024 points in shared memory, or the
    # 8192 points whose coordinates registers hold at D=3.
    smem_points = (_SMEM - 4 * D) // (4 * D * 1024) * 1024
    assert res == _SMS * min(max(smem_points, 8192 if D == 3 else 0), 32 * 1024)
    assert reg == _SMS * 32 * 1024
    # fps_limits reports the same capacities the plan follows.
    monkeypatch.setattr(kf, "_card", lambda index: (_SMS, _SMEM))
    assert kf.fps_limits(D, "cuda:0") == (_SMEM // (4 * (D + 1)), res)


def test_grid_plan_refuses_too_many_blocks():
    with pytest.raises(ValueError):
        kf._grid_plan(1, 10, 3, kf.MAX_GRID_BLOCKS + 1, _SMEM)


def test_route_and_wrappers_launch_or_raise(monkeypatch):
    """On the CPU every route runs the plain twin; a tensor that is neither
    CPU nor CUDA raises, and no CPU tensor reaches a kernel. On the card,
    ``route`` follows the capacities ``fps_limits`` and ``cluster_limit``
    report: the cluster path past the block cap at D=3 (one cloud only up to
    ``ONE_CLOUD_CLUSTER_MAX``), the grid entry points past it."""
    assert ofps.route(torch.zeros((2, 10, 3))) is kf.fps_batched
    limits = {3: (14464, 2433024), 16: (3403, 405504)}
    cluster_max = {3: 16 * 16384, 16: 0}
    monkeypatch.setattr(kf, "fps_limits", lambda D, device: limits[D])
    monkeypatch.setattr(kf, "cluster_limit", lambda D, device: cluster_max[D])
    one = ofps.ONE_CLOUD_CLUSTER_MAX
    for D, (block_max, resident_max) in limits.items():
        grid_from = max(block_max, cluster_max[D]) + 1
        for N, P, want in ((2, 1, kf.fps_batched), (2, block_max, kf.fps_batched),
                           (2, block_max + 1, kf.fps_clustered),
                           (2, 20_000, kf.fps_clustered), (4, 80_000, kf.fps_clustered),
                           (1, 80_000, kf.fps_clustered), (1, one, kf.fps_clustered),
                           (1, one + 1, kf.fps_resident),
                           (2, one + 1, kf.fps_clustered),
                           (2, cluster_max[D], kf.fps_clustered),
                           (2, grid_from, kf.fps_resident),
                           (2, resident_max, kf.fps_resident),
                           (2, resident_max + 1, kf.fps_streaming),
                           (2, 6_000_000, kf.fps_streaming)):
            if D != 3 and want is kf.fps_clustered:
                want = kf.fps_resident  # no cluster path at D != 3
            if P > block_max or want is kf.fps_batched:
                card = types.SimpleNamespace(shape=(N, P, D), is_cuda=True,
                                             device="cuda:0")
                assert ofps.route(card) is want, (D, N, P)
    meta = torch.zeros((1, 4, 3), device="meta")
    ml = torch.zeros((1,), dtype=torch.int64, device="meta")
    for fn in (kf.fps_batched, kf.fps_clustered, kf.fps_resident, kf.fps_streaming):
        with pytest.raises(ValueError):
            fn(meta, ml, ml, ml, 2)
    one = torch.ones((1,), dtype=torch.int64)
    with pytest.raises(ValueError):
        kf._launch("block", torch.zeros((1, 4, 3)), one, one, one, 2)


# The block kernel's plans (kernels/fps.py _block_plan), up to the block cap
# fps_limits(D)[0] = the shared memory a block may take over (D + 1) * 4.
def _block_cap(D):
    return _SMEM // ((D + 1) * 4)


def _check_block_plan(P, D, plan):
    """The plan holds P points, with the fewest slots of ``SLOTS`` that do
    at its thread count; at D=3 coordinates in registers up to 8192 points
    (no shared memory), else the coordinates in shared memory within the
    budget: rows of slots * threads points at D=3, of P at any other D."""
    assert (plan.threads, plan.slots) in kf.BLOCK_PLANS[3 if D == 3 else 0]
    assert plan.threads * plan.slots >= P
    assert plan.slots == min(s for s in kf.SLOTS if plan.threads * s >= P)
    in_regs = D == 3 and plan.threads * plan.slots <= 8192
    assert plan.smem_bytes == (0 if in_regs else 4 * D * (
        plan.threads * plan.slots if D == 3 else P))
    assert plan.smem_bytes <= _SMEM


@pytest.mark.parametrize("D", [1, 2, 3, 4, 16, 64])
def test_block_plan_holds_every_cloud_up_to_the_cap(D):
    for P in range(1, _block_cap(D) + 1):
        _check_block_plan(P, D, kf._block_plan(P, D))


@pytest.mark.parametrize("D", [1, 3, 16])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_block_plan_at_each_capacity(D, edge):
    """At T * SLOTS - 1, T * SLOTS and T * SLOTS + 1 of each plan up to the
    cap, the first plan that holds the cloud, and the cap itself."""
    plans = kf.BLOCK_PLANS[3 if D == 3 else 0]
    for i, (t, s) in enumerate(plans):
        P = t * s + edge
        if P > _block_cap(D):
            continue
        plan = kf._block_plan(P, D)
        _check_block_plan(P, D, plan)
        assert (plan.threads, plan.slots) == (plans[i + 1] if edge == 1 else (t, s))
    _check_block_plan(_block_cap(D), D, kf._block_plan(_block_cap(D), D))


def test_block_plan_config_2_and_past_the_largest():
    """Config 2 (32 x 4,096 points, D=3) takes a register plan; past the
    largest plan the wrapper raises."""
    plan = kf._block_plan(4096, 3)
    assert plan.smem_bytes == 0 and plan.threads * plan.slots == 4096
    t, s = kf.BLOCK_PLANS[0][-1]
    with pytest.raises(ValueError):
        kf._block_plan(t * s + 1, 1)


@pytest.mark.parametrize("D", [1, 3, 16])
def test_route_keeps_the_block_cap(D, monkeypatch):
    """``fps_limits`` (unchanged) sends the cap to ``fps_batched`` and the
    cap + 1 to the cluster path at D=3 and to a grid entry point at any
    other D, on an H100's SM count, shared memory and clusters."""
    monkeypatch.setattr(kf, "_card", lambda index: (_SMS, _SMEM))
    monkeypatch.setattr(kf, "_cluster_card", lambda index: _ACTIVE)
    cap = _block_cap(D)
    assert kf.fps_limits(D, "cuda:0")[0] == cap
    above = kf.fps_clustered if D == 3 else kf.fps_resident
    for P, want in ((cap, kf.fps_batched), (cap + 1, above)):
        card = types.SimpleNamespace(shape=(4, P, D), is_cuda=True, device="cuda:0")
        assert ofps.route(card) is want, (D, P)


@pytest.mark.parametrize("D", [3, 16])
def test_fps_batched_plan_runs_the_plain_twin_on_cpu(D):
    """On CPU tensors ``fps_batched`` runs the plain twin whatever plan it
    is given; a meta tensor raises."""
    pts = _points(17 + D, 3, 40, D=D, grid=True)
    lengths, K, starts = np.array([40, 17, 0]), np.array([30, 30, 5]), np.array([3, 16, 0])
    ref = kf.fps_plain(_t(pts), _t(lengths), _t(K), _t(starts), 30)
    for plan in (None, kf._block_plan(40, D)):
        out = kf.fps_batched(_t(pts), _t(lengths), _t(K), _t(starts), 30, _plan=plan)
        assert torch.equal(out, ref)
    meta = torch.zeros((1, 4, D), device="meta")
    ml = torch.zeros((1,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kf.fps_batched(meta, ml, ml, ml, 2, _plan=kf._block_plan(4, D))


# ---- the cluster path: one thread-block cluster per cloud ------------------


def _check_cluster_plan(N, P, lengths, plan, active):
    """The plan's instance runs on the card (and within the clusters it is
    given); its blocks' slices of every cloud (ragged lengths up to P) tile
    [0, L) in order, each within a block's capacity; within a slice, slot
    s of thread t is point s * threads + t, so the slots a slice fills
    visit each of its points once; ``waves`` counts the clusters in turn."""
    assert plan.cluster in kf.CLUSTERS
    assert (plan.threads, plan.slots) in kf.CLUSTER_BLOCKS
    assert active[(plan.threads, plan.slots, plan.cluster)] > 0
    assert plan.slice == -(-P // plan.cluster) <= plan.threads * plan.slots
    spread = min(active[(plan.threads, plan.slots, plan.cluster)],
                 active.get((1024, 16, plan.cluster), 0)) or active[
                     (plan.threads, plan.slots, plan.cluster)]
    assert plan.waves == -(-N // spread)
    for L in lengths:
        sl = -(-L // plan.cluster) if L else 0
        seen = np.zeros(L, np.int64)
        for r in range(plan.cluster):
            p0 = min(r * sl, L)
            cnt = min(p0 + sl, L) - p0
            assert 0 <= cnt <= plan.slice
            slots = -(-cnt // plan.threads)
            assert slots <= plan.slots
            q = np.arange(slots)[:, None] * plan.threads + np.arange(plan.threads)[None, :]
            assert (np.diff(q, axis=0) > 0).all()
            q = q[q < cnt]
            np.add.at(seen, p0 + q, 1)
        assert (seen == 1).all(), L


_SMALL_CARD = {k: (v if k[2] <= 4 else 0) for k, v in _ACTIVE.items()}


@pytest.mark.parametrize("active", [_ACTIVE, _SMALL_CARD], ids=["h100", "clusters_of_4"])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_cluster_plan_covers_each_point_once(active, edge):
    """At each capacity edge of each cluster instance (C x threads x 16
    points, -1/+0/+1), for batches of 1, 4 and 12 clouds with ragged
    lengths, lengths 0 and 1 among them; past the largest cluster the card
    runs the plan raises."""
    cap = kf._cluster_cap(active)
    for t, s, c in kf.CLUSTER_PLANS:
        P = c * t * s + edge
        if not active[(t, s, c)] or P > cap or P < 1:
            continue
        for N in (1, 4, 12):
            plan = kf._cluster_plan(N, P, 3, active)
            _check_cluster_plan(N, P, [P, P - 1, 0, 1, P // 3 + 1, 33][:max(N, 6)],
                                plan, active)
    with pytest.raises(ValueError):
        kf._cluster_plan(4, cap + 1, 3, active)
    with pytest.raises(ValueError):
        kf._cluster_plan(4, 20_000, 16, active)


def test_cluster_plan_picks_the_size_by_shape():
    """On an H100: the most blocks a cloud that run every cloud at once at
    one block an SM; a card that runs no cluster past 4 blocks gets 4."""
    def pick(N, P, active=_ACTIVE):
        p = kf._cluster_plan(N, P, 3, active)
        return p.cluster, p.threads, p.waves

    assert pick(4, 20_000) == (16, 256, 1)     # the cell's level 3: 1,250 a block
    assert pick(4, 80_000) == (16, 512, 1)     # the cell's level 2: 5,000 a block
    assert pick(1, 14_465) == (16, 256, 1)
    assert pick(8, 80_000) == (8, 1024, 1)     # 7 clusters of 16 at once: 8 of 8
    assert pick(8, 20_000) == (8, 256, 1)      # 16 x 256-thread blocks would share SMs
    assert pick(40, 20_000) == (2, 1024, 1)
    assert pick(8, 250_000) == (16, 1024, 2)   # only clusters of 16 hold 15,625 a block
    assert pick(4, 20_000, _SMALL_CARD) == (4, 512, 1)
    assert kf._cluster_cap(_SMALL_CARD) == 4 * 16384
    assert kf._cluster_cap(_ACTIVE) == 16 * 16384


def test_cluster_limit_and_wrapper(monkeypatch):
    """``cluster_limit`` is the largest cluster of the largest slice at
    D=3, 0 at any other D; ``fps_clustered`` runs the plain twin on CPU
    tensors whatever plan it is given and raises on any other device."""
    monkeypatch.setattr(kf, "_cluster_card", lambda index: _ACTIVE)
    assert kf.cluster_limit(3, "cuda:0") == 262_144
    assert kf.cluster_limit(1, "cuda:0") == kf.cluster_limit(16, "cuda:0") == 0
    pts = _points(21, 3, 50, grid=True)
    lengths, K, starts = np.array([50, 17, 0]), np.array([40, 40, 5]), np.array([3, 16, 0])
    ref = kf.fps_plain(_t(pts), _t(lengths), _t(K), _t(starts), 40)
    for plan in (None, kf._cluster_plan(3, 50, 3, _ACTIVE)):
        out = kf.fps_clustered(_t(pts), _t(lengths), _t(K), _t(starts), 40, _plan=plan)
        assert torch.equal(out, ref)


def _cluster_fps_model(points, lengths, K, starts, max_K, C, threads):
    """The cluster path's scheme in plain numpy, one cloud at a time: C
    contiguous slices, slot s of thread t at point s * threads + t of a
    slice; each round the distances summed axis by axis as ``fps_plain``
    sums them, each thread's first maximum by a strict compare from -1, its
    key (float bits of the value) << 32 | (0xFFFFFFFF - index), a warp's
    record the largest key of its 32 threads, a block's the largest of its
    warps', the winner the largest of the C blocks' records."""
    pts = points.numpy()
    N, P, D = pts.shape
    out = np.full((N, max_K), -1, np.int64)
    warps = threads // 32
    for n in range(N):
        L = min(max(int(lengths[n]), 0), P)
        k_n = 0 if L == 0 else min(max(min(int(K[n]), L), 0), max_K)
        if k_n > 0:
            out[n, 0] = int(starts[n])
        if k_n <= 1:
            continue
        last = min(max(int(starts[n]), 0), L - 1)
        sl = -(-L // C)
        md = torch.full((L,), float("inf"))
        x = torch.from_numpy(pts[n, :L])
        for r in range(1, k_n):
            d2 = x.new_zeros((L,))
            for d in range(D):
                diff = x[:, d] - x[last, d]
                d2 = d2 + diff * diff
            md = torch.minimum(md, d2)
            records = np.zeros((C, warps), np.uint64)
            for rank in range(C):
                p0 = min(rank * sl, L)
                cnt = min(p0 + sl, L) - p0
                slots = -(-cnt // threads)
                best = np.zeros(threads, np.uint64)
                for t in range(threads):
                    bv, fs = -1.0, -1
                    for s in range(slots):
                        q = s * threads + t
                        if q < cnt and md[p0 + q].item() > bv:
                            bv, fs = md[p0 + q].item(), s
                    if fs >= 0:
                        bits = int(np.float32(bv).view(np.uint32))
                        best[t] = (bits << 32) | (0xFFFFFFFF - (p0 + fs * threads + t))
                records[rank] = best.reshape(warps, 32).max(axis=1)
            win = int(records.max(axis=1).max())
            last = 0xFFFFFFFF - (win & 0xFFFFFFFF)
            out[n, r] = last
    return torch.from_numpy(out)


@pytest.mark.parametrize("C", [2, 4, 16])
@pytest.mark.parametrize("kind", ["normal", "duplicates"])
def test_cluster_model_equals_plain_twin(C, kind):
    """The cluster scheme, modelled plainly, bit for bit against
    ``fps_plain``: ragged lengths (0, 1, 2, a slice edge), per-cloud K, K
    above the number of distinct points (duplicates: the first maximum may
    be a point already selected), explicit starts."""
    P = 150
    pts = _points(30 + C, 6, P, grid=kind == "duplicates")
    lengths = np.array([150, 97, 0, 1, 2, 64 * C + 1 if 64 * C + 1 <= P else 130])
    K = np.array([40, 97, 5, 3, 2, 30]) if kind == "duplicates" else np.array([25, 12, 5, 3, 2, 30])
    starts = np.array([0, 96, 0, 0, 1, 5])
    args = (_t(pts), _t(lengths), _t(K), _t(starts), int(K.max()))
    want = kf.fps_plain(*args)
    got = _cluster_fps_model(*args, C=C, threads=64)
    assert torch.equal(got, want)
    if kind == "duplicates":  # 27 distinct points: rounds past them pick selected ones
        assert len(set(want[1].tolist())) < 97
