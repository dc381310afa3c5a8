"""The port's kth-bound seeding of the KNN kernel (``kernels/knn.py``:
``knn_topk(ub=, sample_bound=, sample_s=)``, ``kth_bounds``, the repair)
against the JAX package's seeded ``knn_forward_pallas`` (interpret mode)
and ``_bigk_round_bounds``, on the CPU, at the sizes of the JAX package's
own seeded tests. The same numpy inputs go through both: indices exactly
equal, values within 1e-5; every seeded call is also bit-equal to the
port's unseeded call."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels import knn_pallas as kp
from pytorch3d_pointops_tpu.ops.knn import _knn_forward_full as jax_knn_forward_full
from pytorch3d_pointops_tpu_torch.kernels import knn as kk
from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions

torch.set_num_threads(2)
TOL = 1e-5


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _grid(seed, N, P1, P2, levels):
    rng = np.random.default_rng(seed)
    p1 = rng.integers(0, levels, size=(N, P1, 3)).astype(np.float32)
    p2 = rng.integers(0, levels, size=(N, P2, 3)).astype(np.float32)
    return p1, p2


def _normal(seed, N, P1, P2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, P1, 3)).astype(np.float32),
            rng.normal(size=(N, P2, 3)).astype(np.float32))


def _same(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _vs_jax(out, ref, lengths2, K):
    """Indices equal and values within TOL after the pad conventions."""
    N, P1 = out[0].shape[:2]
    full = torch.full((N,), P1)
    d, i = _apply_pad_conventions(*out, full, lengths2, K, P1)
    dr, ir = _apply_pad_conventions(_t(ref[0]), _t(ref[1]).long(), full, lengths2, K, P1)
    assert torch.equal(i, ir)
    np.testing.assert_allclose(d.numpy(), dr.numpy(), atol=TOL)


def test_raw_ub_at_the_exact_kth_equals_unseeded_and_jax():
    """A bound equal to the exact kth (ties included) is inclusive: the
    seeded round fills fully and equals the unseeded one, and JAX's seeded
    kernel given the same bound."""
    p1, p2 = _grid(31, 2, 40, 200, 3)
    l2 = np.array([200, 150])
    args = (_t(p1), _t(p2), _t(l2))
    K = 8
    d0, i0 = kk.knn_topk(*args, K, 2)
    ub = d0[..., K - 1].contiguous()
    out = kk.knn_topk(*args, K, 2, ub=ub)
    _same(out, (d0, i0))
    assert not (out[1] == kk.SENT).any()
    ref = kp.knn_forward_pallas(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2),
                                K=K, tile_p1=32, tile_p2=64, interpret=True,
                                ub=jnp.asarray(ub.numpy()))
    _vs_jax(out, ref, args[2], K)


@pytest.mark.parametrize("sort_queries", [False, True])
def test_raw_ub_too_tight_leaves_sentinels_like_jax(sort_queries):
    """A bound at the 4th distance: slots 0-3 are the exact prefix, slots
    4-7 keep (seed_of(ub), SENT), as JAX's raw kernel leaves them; the
    plain twin given the same bound is the same state."""
    p1, p2 = _normal(32, 1, 24, 120)
    l2 = np.array([120])
    args = (_t(p1), _t(p2), _t(l2))
    K, cut = 8, 4
    d0, i0 = kk.knn_topk(*args, K, 2)
    ub = d0[..., cut - 1].contiguous()
    d, i = kk.knn_topk(*args, K, 2, ub=ub, sort_queries=sort_queries)
    assert torch.equal(d[..., :cut], d0[..., :cut])
    assert torch.equal(i[..., :cut], i0[..., :cut])
    assert (i[..., cut:] == kk.SENT).all()
    seed = np.maximum(np.nextafter(ub.numpy(), np.float32(np.inf)),
                      np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(d[..., cut:].numpy(),
                                  np.broadcast_to(seed[..., None], (1, 24, K - cut)))
    _same((d, i), kk.knn_topk_plain(*args, K, 2, ub=ub))
    dj, ij = kp.knn_forward_pallas(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2),
                                   K=K, tile_p1=8, tile_p2=64, interpret=True,
                                   ub=jnp.asarray(ub.numpy()))
    assert torch.equal(i, _t(ij).long())
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), atol=TOL)


def test_plain_twin_seed_edge_tie_rule():
    """A candidate exactly at the seed: the seed entries sort first and it
    is not admitted, as in the kernel. Below the seed it is admitted."""
    p1 = torch.zeros((1, 1, 3))
    p2 = torch.tensor([[[0.5, 0, 0], [2.0, 0, 0], [0.25, 0, 0]]])
    l2 = torch.tensor([3])
    ub = torch.nextafter(torch.tensor([[0.25]]), torch.tensor(-1.0))  # seed 0.25
    d, i = kk.knn_topk_plain(p1, p2, l2, 2, 2, ub=ub)
    assert i.tolist() == [[[2, kk.SENT]]] and d.tolist() == [[[0.0625, 0.25]]]
    d, i = kk.knn_topk_plain(p1, p2, l2, 2, 2, ub=torch.tensor([[0.25]]))
    assert i.tolist() == [[[2, 0]]]


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("case", ["mixed", "short", "deep"])
def test_kth_bounds_match_jax(case, norm):
    """``kth_bounds`` against ``_bigk_round_bounds``: the same None choice,
    per-cloud ranks equal, bounds within 1e-5 and +inf in the same places
    (clouds shorter than P2 // 2 unused), lengths above and below P2 // 2.
    The quantiles are small (sample K=24) to keep the interpreted JAX
    kernel short; the arithmetic is the same at any quantile."""
    p1, p2 = _grid(40 + norm, 3, 37, 1024, 5)
    l2 = {"mixed": [1024, 700, 400], "short": [511, 512, 1000], "deep": [1024] * 3}[case]
    kqs = {"mixed": [4, 8], "short": [3, 6, 8], "deep": [64, 128, 192, 256, 320, 384]}[case]
    s = 256
    l2 = np.array(l2)
    ref = kp._bigk_round_bounds(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2), kqs,
                                norm, s, True, 32, 256)
    out = kk.kth_bounds(_t(p1), _t(p2), _t(l2), kqs, norm, s)
    assert (out is None) == (ref is None)
    m_max, m_r, usable = kk.bound_ranks(_t(l2), kqs, s, 1024)
    assert m_max == kp._bound_m(s * kqs[-1] / 512)
    mu = s * jnp.asarray(kqs, jnp.float32)[None, :] / jnp.maximum(
        jnp.asarray(l2).astype(jnp.float32)[:, None], 1.0)
    np.testing.assert_array_equal(
        m_r.numpy(), np.asarray(kp._rank_formula(mu, jnp.sqrt, jnp.ceil).astype(jnp.int32)))
    if ref is None:
        assert case == "deep"
        return
    assert bool(usable.any()) and not bool(usable.all())
    for tau, tj in zip(out, ref):
        tj = np.asarray(tj)
        np.testing.assert_array_equal(np.isinf(tau.numpy()), np.isinf(tj))
        fin = np.isfinite(tj)
        np.testing.assert_allclose(tau.numpy()[fin], tj[fin], atol=TOL)


_SEEDED_CASES = {
    # name: (clouds, lengths2, K, norm, sample_s, JAX reference: the seeded
    # kernel in interpret mode, or the single-shot forward where that would
    # take a minute)
    "K=100 tie cloud": (lambda: _grid(33, 2, 40, 2048, 4), [2048, 700], 100, 2, 256,
                        "full"),
    "K=80 norm 1": (lambda: _normal(34, 1, 30, 1536), [1536], 80, 1, 256, "full"),
    "K=16 one round": (lambda: _normal(36, 1, 33, 1280), [1280], 16, 2, 256, "pallas"),
    "K=130 ragged": (lambda: _grid(37, 3, 50, 1100, 6), [1100, 0, 600], 130, 2, 256,
                     "full"),
}


@pytest.mark.parametrize("sort_queries", [False, True])
@pytest.mark.parametrize("case", sorted(_SEEDED_CASES))
def test_sampled_seeding_matches_jax_and_unseeded(case, sort_queries):
    """``knn_topk(sample_bound=True)`` on CPU tensors runs the seeded
    rounds and the repair over the plain twin: bit-equal to the unseeded
    call, the queries sorted or not, and equal to the JAX package (its
    seeded kernel in interpret mode, or its single-shot forward for the
    larger cases)."""
    make, l2, K, norm, s, ref_kind = _SEEDED_CASES[case]
    p1, p2 = make()
    l2 = np.array(l2)
    args = (_t(p1), _t(p2), _t(l2))
    base = kk.knn_topk(*args, K, norm, sort_queries=False)
    out = kk.knn_topk(*args, K, norm, sample_bound=True, sample_s=s,
                      sort_queries=sort_queries)
    _same(out, base)
    if sort_queries:
        return
    if ref_kind == "pallas":
        ref = kp.knn_forward_pallas(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l2),
                                    K=K, norm=norm, tile_p1=32, tile_p2=256,
                                    interpret=True, sample_bound=True, sample_s=s)
    else:
        N, P1 = p1.shape[:2]
        ref = jax_knn_forward_full(jnp.asarray(p1), jnp.asarray(p2), jnp.full((N,), P1),
                                   jnp.asarray(l2), K, norm)
    _vs_jax(out, ref, args[2], K)


def _counting_rounds(monkeypatch):
    calls = []
    plain_round = kk._plain_round

    def counted(*a, **kw):
        calls.append(a[3])
        return plain_round(*a, **kw)

    monkeypatch.setattr(kk, "_plain_round", counted)
    return calls


@pytest.mark.parametrize("K", [16, 100])
def test_too_tight_bounds_are_repaired(monkeypatch, K):
    """Bounds of -1 (every slot of a seeded round left at SENT; at K > 64
    every screened list short of K): the gate word is 1 (every query
    flagged), every round runs again unseeded, and the result is the
    unseeded one. With the real bounds the rerun is skipped."""
    p1, p2 = _normal(35, 1, 41, 1024)
    args = (_t(p1), _t(p2), torch.tensor([1024]))
    base = kk.knn_topk(*args, K, 2)
    rounds = kk._rounds(K, 1024)
    screened = rounds > 1  # screen and select in place of seeded rounds
    calls = _counting_rounds(monkeypatch)
    _same(kk.knn_topk(*args, K, 2, sample_bound=True, sample_s=256), base)
    assert len(calls) == 1 + (0 if screened else rounds)  # the sample pass, rounds

    def bad_bounds(p1, p2, lengths2, kqs, norm, s, rows=None):
        return [torch.full(p1.shape[:2], -1.0) for _ in kqs]

    monkeypatch.setattr(kk, "kth_bounds", bad_bounds)
    calls.clear()
    _same(kk.knn_topk(*args, K, 2, sample_bound=True, sample_s=256), base)
    assert len(calls) == (1 if screened else 2) * rounds
    seeds = [kk.seed_of(t) for t in bad_bounds(*args, kk._quantiles(K, 1024), 2, 256)]
    launch = kk._plain_launcher(*args, 2)
    ds, idxs = kk._chain(launch, K, 1024, seeds)
    assert int(kk.repair_gate(idxs, args[2], K)) == 1
    assert int(kk.repair_gate(*kk._chain(launch, K, 1024)[1:], args[2], K)) == 0


@pytest.mark.parametrize("sort_queries", [False, True])
@pytest.mark.parametrize("case", ["K=80 norm 1", "K=100 tie cloud", "K=130 ragged",
                                  "K=100 tie cloud, bounds -1"])
def test_seeded_chained_rounds_past_the_select_limit(monkeypatch, case, sort_queries):
    """Past the select's limit (``_SELECT_MAX_K`` lowered below K) a seeded
    call of more than one round keeps the seeded chained rounds, as the JAX
    package's ``_knn_forward_pallas_bigk`` does: ``kth_bounds`` at every
    round's quantile, one seed a round, the rounds and their repair,
    bit-equal to the unseeded call. With every bound -1 no round fills, the
    gate word is 1, every round reruns unseeded, and the result is still
    the unseeded one."""
    forced = case.endswith("bounds -1")
    make, l2, K, norm, s, _ = _SEEDED_CASES[case.split(",")[0]]
    p1, p2 = make()
    args = (_t(p1), _t(p2), _t(np.array(l2)))
    P2 = p2.shape[1]
    base = kk.knn_topk(*args, K, norm, sort_queries=False)
    monkeypatch.setattr(kk, "_SELECT_MAX_K", K - 1)
    seeded = []
    real_seeded = kk._seeded

    def counted(launch, K, P2, lengths2, seeds):
        seeded.append(len(seeds))
        return real_seeded(launch, K, P2, lengths2, seeds)

    monkeypatch.setattr(kk, "_seeded", counted)
    if forced:
        monkeypatch.setattr(kk, "kth_bounds", lambda p1, p2, lengths2, kqs, norm, s,
                            rows=None: [torch.full(p1.shape[:2], -1.0) for _ in kqs])
    rounds = _counting_rounds(monkeypatch)
    out = kk.knn_topk(*args, K, norm, sample_bound=True, sample_s=s,
                      sort_queries=sort_queries)
    _same(out, base)
    R = kk._rounds(K, P2)
    assert R > 1 and seeded == [R]
    if forced:
        assert len(rounds) == 2 * R  # the seeded rounds, then each one again


@pytest.mark.parametrize("K", [16, 100, 150])
def test_repair_gate_reads_one_slot_a_round(K):
    """``repair_gate`` reads each round at its last live slot only: on
    random states whose SENT slots are a suffix of each row (as a seeded
    round leaves them) it equals the full test (any SENT in a slot k <
    min(K, lengths2)), a failed round 0 followed by a full round 1
    included."""
    rng = np.random.default_rng(K)
    N, P1 = 4, 30
    lengths2 = torch.tensor([0, 5, 70, 1000])
    widths = [min(K - r * kk.ROUND_K, kk.ROUND_K) for r in range(-(-K // kk.ROUND_K))]
    for trial in range(40):
        idxs = []
        for k in widths:
            first = rng.integers(0, k + 1, size=(N, P1)) if trial % 4 else np.full(
                (N, P1), k)
            sent = np.arange(k)[None, None, :] >= first[..., None]
            idxs.append(torch.where(torch.tensor(sent), kk.SENT, 1))
        if trial % 8 == 1 and len(widths) > 1:
            idxs[1][:] = 1  # round 0 may fail while round 1 is full
        full = torch.cat(idxs, dim=2)
        live = torch.arange(K)[None, None, :] < lengths2[:, None, None]
        want = int(((full == kk.SENT) & live).any())
        assert int(kk.repair_gate(idxs, lengths2, K)) == want
        assert int(kk.repair_gate(full.split(kk.ROUND_K, dim=2), lengths2, K)) == want


def test_sentinels_past_lengths2_become_inf_zero():
    """A cloud shorter than K: its seeded slots past lengths2 keep SENT,
    which is no failure (the gate stays 0) and ends as (inf, 0), as
    unseeded."""
    p1, p2 = _normal(38, 1, 20, 300)
    args = (_t(p1), _t(p2), torch.tensor([10]))
    ub = torch.full((1, 20), 100.0)
    launch = kk._plain_launcher(*args, 2)
    ds, idxs = kk._chain(launch, 16, 300, [kk.seed_of(ub)])
    assert (idxs[0][..., 10:] == kk.SENT).all()
    assert int(kk.repair_gate(idxs, args[2], 16)) == 0
    d, i = kk._seeded(launch, 16, 300, args[2], [kk.seed_of(ub)])
    _same((d, i), kk.knn_topk(*args, 16, 2))
    assert torch.isinf(d[..., 10:]).all() and (i[..., 10:] == 0).all()


def test_sample_bound_warns_where_no_sample_applies(caplog):
    """P2 < 4 * s: ``sample_bound=True`` logs a warning and runs unseeded."""
    p1, p2 = _normal(39, 1, 20, 500)
    args = (_t(p1), _t(p2), torch.tensor([500]))
    with caplog.at_level(logging.WARNING, logger=kk.__name__):
        out = kk.knn_topk(*args, 16, 2, sample_bound=True, sample_s=256)
    assert "sample_bound=True ignored" in caplog.text
    _same(out, kk.knn_topk(*args, 16, 2))


def test_seed_gate():
    """The auto gate seeds K > 64 on CUDA where a sample applies, single
    rounds only in SEED_SINGLE_ROUND_BUCKETS, nothing on the CPU or at K=1;
    an explicit choice stands where a sample applies."""
    s = kk._default_sample_s(100_000)
    assert s == 6144 and kk._default_sample_s(10_000) == 4096
    assert kk._default_sample_s(10**7) == 65536
    assert kk.seed_gate(100, 100_000, s, True)
    assert not kk.seed_gate(100, 100_000, s, False)
    assert not kk.seed_gate(100, 20_000, s, True)  # P2 < 4 * s
    for K in (16, 32, 64):
        assert kk.seed_gate(K, 100_000, s, True) == (
            kk._bucket(K) in kk.SEED_SINGLE_ROUND_BUCKETS)
        assert kk.seed_gate(K, 100_000, s, False, True)
    assert not kk.seed_gate(1, 100_000, s, True, True)
    assert not kk.seed_gate(100, 100_000, s, True, False)
    # The deepest rank past min(s, 512): K=1000 over 16,384 points, s=4096.
    assert kk._max_rank(kk._quantiles(1000, 16384), 16384, 4096) > 512
    assert not kk.seed_gate(1000, 16384, 4096, True)
    assert kk._quantiles(100, 100_000) == [64, 100]
    assert kk._quantiles(200, 130) == [64, 128, 192]  # as knn_pallas.py's kqs


def test_unserved_seeding_requests_raise():
    p = torch.zeros((1, 40, 3))
    l2 = torch.full((1,), 40)
    ub = torch.zeros((1, 40))
    for K in (1, 65):
        with pytest.raises(ValueError, match="one round"):
            kk.knn_topk(p, p, l2, K, 2, ub=ub)
    with pytest.raises(ValueError, match="not both"):
        kk.knn_topk(p, p, l2, 8, 2, ub=ub, sample_bound=True)
    with pytest.raises(ValueError, match=r"\(N, P1\)"):
        kk.knn_topk(p, p, l2, 8, 2, ub=torch.zeros((1, 39)))
    with pytest.raises(ValueError, match="instrument"):
        kk.knn_topk_cuda(p, p, l2, 16, 2, sample_bound=True, instrument=True)
