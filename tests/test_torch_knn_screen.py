"""The port's screen and select for seeded KNN calls of more than one round
(``kernels/knn.py``: ``_screened``, ``_plain_screener``, ``screen_cap``,
``screen_keys``), on the CPU through the plain twin, which takes the same
route as the card: every candidate below its query's seed is listed, the K
smallest keys are read off the list, and the flagged queries (too few
entries, more than the capacity, no finite seed) rerun the chained
unseeded rounds alone. Each call is held bit for bit to the unseeded
chained rounds, and to the JAX package's single-shot forward and its
``_knn_forward_pallas_bigk`` (interpret mode, unseeded; see ``_held``), on
one batch shape so that JAX traces its kernel once a norm."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.kernels import knn_pallas as kp
from pytorch3d_pointops_tpu.ops.knn import _knn_forward_full as jax_knn_forward_full
from pytorch3d_pointops_tpu_torch.kernels import knn as kk
from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions

torch.set_num_threads(2)

N, P1, P2, S = 3, 32, 1100, 256  # every case's batch shape and sample size
TOL = 1e-5  # JAX's distances are summed in another order: values within 1e-5


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _clouds(seed, levels=None):
    """Gaussian clouds, or points on a grid of ``levels`` steps a side (many
    exact ties)."""
    rng = np.random.default_rng(seed)
    if levels is None:
        return (rng.normal(size=(N, P1, 3)).astype(np.float32),
                rng.normal(size=(N, P2, 3)).astype(np.float32))
    return (rng.integers(0, levels, size=(N, P1, 3)).astype(np.float32),
            rng.integers(0, levels, size=(N, P2, 3)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_bigk(seed, levels, lengths, K, norm):
    p1, p2 = _clouds(seed, levels)
    d, i = kp._knn_forward_pallas_bigk(jnp.asarray(p1), jnp.asarray(p2),
                                       jnp.asarray(lengths), K, norm, 32, 256, True,
                                       sample_bound=False)
    return np.asarray(d), np.asarray(i)


def _held(out, seed, levels, lengths, K, norm):
    """``out`` bit-equal to the port's unseeded chained rounds and, after the
    pad conventions, to JAX's single-shot forward (indices equal, values
    within TOL) and to JAX's chained rounds: values within TOL, indices
    equal but at a near tie. JAX's kernel sums a distance in another order
    than its own single-shot forward, so two values one float apart there
    (5.5210195 / 5.52102 against equal values) may trade places."""
    p1, p2 = _clouds(seed, levels)
    args = (_t(p1), _t(p2), _t(lengths))
    base = kk.knn_topk(*args, K, norm, sample_bound=False)
    assert torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])
    full = torch.full((N,), P1)
    d, i = _apply_pad_conventions(*out, full, args[2], K, P1)
    df, i_f = jax_knn_forward_full(jnp.asarray(p1), jnp.asarray(p2), jnp.full((N,), P1),
                                   jnp.asarray(lengths), K, norm)
    df, i_f = _apply_pad_conventions(_t(df), _t(i_f).long(), full, args[2], K, P1)
    assert torch.equal(i, i_f)
    np.testing.assert_allclose(d.numpy(), df.numpy(), rtol=0, atol=TOL)
    dj, ij = _jax_bigk(seed, levels, tuple(lengths), K, norm)
    dr, ir = _apply_pad_conventions(_t(dj), _t(ij).long(), full, args[2], K, P1)
    np.testing.assert_allclose(d.numpy(), dr.numpy(), rtol=0, atol=TOL)
    gap = (dr[..., 1:] - dr[..., :-1]).abs() <= TOL
    near = torch.zeros_like(gap[..., :1])
    near = torch.cat([gap, near], dim=-1) | torch.cat([near, gap], dim=-1)
    assert ((i == ir) | near).all()


@pytest.fixture
def flags_seen(monkeypatch):
    """Each plain screen's flags (N, P1), in the order of the calls."""
    seen = []
    real = kk._plain_screener

    def recording(*a, **kw):
        screen = real(*a, **kw)

        def wrapped(*sa):
            flags = screen(*sa)
            seen.append(flags.clone())
            return flags
        return wrapped

    monkeypatch.setattr(kk, "_plain_screener", recording)
    return seen


def _bounds_scaled(monkeypatch, scale):
    """``kth_bounds`` with each cloud's bounds times ``scale[n]``."""
    real = kk.kth_bounds

    def scaled(*a, **kw):
        return [t * torch.tensor(scale)[:, None] for t in real(*a, **kw)]

    monkeypatch.setattr(kk, "kth_bounds", scaled)


@pytest.mark.parametrize("sort_queries", [False, True])
@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("K", [100, 130])
def test_screen_and_select_equal_the_chained_rounds(flags_seen, K, norm, sort_queries):
    """The default seeded route at K > 64: one screen, no query flagged on
    Gaussian clouds, the result the unseeded one and JAX's, each sort."""
    lengths = (P2, P2, P2)
    p1, p2 = _clouds(1)
    out = kk.knn_topk(_t(p1), _t(p2), _t(lengths), K, norm, sample_bound=True,
                      sample_s=S, sort_queries=sort_queries)
    assert len(flags_seen) == 1 and not flags_seen[0].any()
    _held(out, 1, None, lengths, K, norm)


@pytest.mark.parametrize("sort_candidates", [False, True])
def test_ties_across_the_kth_slot(flags_seen, sort_candidates):
    """A grid cloud with ties across slot K: the select breaks them by
    index (the original index, with the candidates sorted), as the rounds
    do."""
    lengths = (P2, P2, 900)
    p1, p2 = _clouds(2, levels=5)
    args = (_t(p1), _t(p2), _t(lengths))
    wide = kk.knn_topk(*args, 101, 2, sample_bound=False)[0]
    assert (wide[..., 99] == wide[..., 100]).any()  # ties across the K-th slot
    out = kk.knn_topk(*args, 100, 2, sample_bound=True, sample_s=S,
                      sort_candidates=sort_candidates)
    assert not flags_seen[0].any()
    _held(out, 2, 5, lengths, 100, 2)


def test_a_candidate_at_the_seed_is_left_out(monkeypatch, flags_seen):
    """Seeds equal to each query's exact K-th distance (ties there
    included): the strict ``d < seed`` leaves that candidate out, every list
    is one short, every query is flagged and repaired. One float above it,
    nothing is flagged. Both results are exact."""
    lengths = (P2, P2, P2)
    p1, p2 = _clouds(3, levels=5)
    args = (_t(p1), _t(p2), _t(lengths))
    K = 100
    kth = kk.knn_topk(*args, K, 2, sample_bound=False)[0][..., K - 1]
    for seed, flagged in ((kth, True), (torch.nextafter(kth, torch.tensor(np.inf)),
                                        False)):
        tau = torch.nextafter(seed, torch.tensor(-np.inf))  # seed_of(tau) == seed
        assert torch.equal(kk.seed_of(tau), seed)
        monkeypatch.setattr(kk, "kth_bounds", lambda *a, tau=tau, **kw: [tau])
        out = kk.knn_topk(*args, K, 2, sample_bound=True, sample_s=S)
        assert bool(flags_seen[-1].bool().all()) == flagged
        assert bool(flags_seen[-1].any()) == flagged
        _held(out, 3, 5, lengths, K, 2)


def test_overflowing_lists_are_repaired_alone(monkeypatch):
    """A capacity at the median count: a query whose count passes it (and
    only such a query, or one short of K) is flagged; the select's rows of the
    others are already exact before any repair, and the repaired call is
    the unseeded one."""
    lengths = (P2, 700, P2)
    p1, p2 = _clouds(4)
    args = (_t(p1), _t(p2), _t(lengths))
    K = 100
    seed = kk.seed_of(kk.kth_bounds(*args, [K], 2, S)[0])
    d = kk.pairwise_dist(args[0], args[1], 2)
    live = torch.arange(P2)[None, None, :] < args[2][:, None, None]
    count = ((d < seed[..., None]) & live).sum(dim=-1)
    cap = int(count.median())
    monkeypatch.setattr(kk, "screen_cap", lambda K, P2, s: cap)
    want = (count > cap) | (count < args[2].clamp(max=K)[:, None])
    assert want.any() and not want.all()
    R = kk._rounds(K, P2)
    out = (torch.zeros((R, N, P1, kk.ROUND_K)),
           torch.zeros((R, N, P1, kk.ROUND_K), dtype=torch.int64))
    flags = kk._plain_screener(*args, 2)(K, seed, cap, out)
    assert torch.equal(flags.bool(), want | ~(seed < np.inf))
    base = kk.knn_topk(*args, K, 2, sample_bound=False)
    sel = kk._join(list(out[0]), list(out[1]), K)
    ok = ~flags.bool()
    assert torch.equal(sel[0][ok], base[0][ok]) and torch.equal(sel[1][ok], base[1][ok])
    _held(kk.knn_topk(*args, K, 2, sample_bound=True, sample_s=S), 4, None, lengths,
          K, 2)


def test_bounds_too_tight_on_one_cloud_rerun_that_cloud(monkeypatch, flags_seen):
    """Cloud 1's bounds scaled to a hundredth: its queries' lists are short
    of K and only they are flagged; the result is exact."""
    lengths = (P2, P2, P2)
    p1, p2 = _clouds(5)
    _bounds_scaled(monkeypatch, [1.0, 0.01, 1.0])
    out = kk.knn_topk(_t(p1), _t(p2), _t(lengths), 100, 2, sample_bound=True,
                      sample_s=S)
    (flags,) = flags_seen
    assert flags[1].bool().all() and not flags[0].any() and not flags[2].any()
    _held(out, 5, None, lengths, 100, 2)


@pytest.mark.parametrize("sort_queries", [False, True])
def test_ragged_batch_with_an_unusable_bound(flags_seen, sort_queries):
    """Lengths 1100 / 0 / 600: the empty cloud's bound is unusable (+inf,
    shorter than P2 // 2), so its queries are flagged without a list;
    the others are read off their lists. Slots past lengths2 hold (inf, 0)
    before the pad conventions, as unseeded."""
    lengths = (P2, 0, 600)
    p1, p2 = _clouds(6)
    args = (_t(p1), _t(p2), _t(lengths))
    out = kk.knn_topk(*args, 130, 2, sample_bound=True, sample_s=S,
                      sort_queries=sort_queries)
    (flags,) = flags_seen
    assert flags[1].bool().all() and not flags[0].any() and not flags[2].any()
    assert torch.isinf(out[0][1]).all() and (out[1][1] == 0).all()
    _held(out, 6, None, lengths, 130, 2)


def test_key_order_is_value_then_index():
    """``screen_keys`` sort as (value, index) lexicographically: ties, 0,
    subnormal and large values, indices up to 2**31 - 1."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        rng.choice(np.float32([0.0, 1e-45, 1e-40, 1.1754944e-38, 0.25, 0.5, 3.0e38]),
                   size=500),
        rng.random(500).astype(np.float32)]).astype(np.float32)
    idx = np.concatenate([rng.integers(0, 4, size=500),
                          rng.integers(0, 2**31 - 1, size=500)]).astype(np.int64)
    keys = kk.screen_keys(_t(vals), _t(idx))
    order = torch.argsort(keys).numpy()
    want = np.lexsort((idx, vals))
    np.testing.assert_array_equal(vals[order], vals[want])
    np.testing.assert_array_equal(idx[order], idx[want])
    d, i = kk._unkey(keys)
    assert torch.equal(d, _t(vals)) and torch.equal(i, _t(idx))


def test_screen_cap():
    """The north star's capacity: 1,536 entries (an overflow once in 3e14
    queries), where 1,024 would overflow about once in 7e5; shorter clouds
    are safer."""
    s = kk._default_sample_s(100_000)
    assert kk.screen_cap(100, 100_000, s) == 1536
    m = kk._bound_m(s * 100 / 100_000)
    assert m == 30
    assert kk._poisson_below(1536 * s / 100_000, m) < 1e-14
    assert kk._poisson_below(1024 * s / 100_000, m) > 1e-6
    half = kk._bound_m(s * 100 / 50_000)
    assert kk._poisson_below(1536 * s / 50_000, half) < kk._poisson_below(
        1536 * s / 100_000, m)
    assert kk._screen_chunk(1, 100_000, 1536) == 100_000
    assert kk._screen_chunk(1, 10**6, 1536) * 1536 * 8 <= kk._LIST_BYTES


# The screen's skip (D = 3): the screen runs on ``screen_order_plain``'s
# order and leaves out every segment whose ``segment_bound`` is not below a
# query's seed. Torch only: each case is held to the port's unseeded rounds.


def _bound_case(name):
    """(points (2, 700, 3), lengths, queries (2, 200, 3)) of one bound case;
    the queries are spread over the valid points' scale."""
    rng = np.random.default_rng(sum(map(ord, name)))
    g = rng.normal(size=(2, 700, 3)).astype(np.float32)
    lengths = (700, 700)
    if name == "duplicated":
        g = np.repeat(g[:, :70], 10, axis=1)
    elif name == "plane":
        g[..., 2] = 0.5
    elif name == "line":
        g[..., 1:] = np.float32([2.0, -1.0])
    elif name == "tiny":
        g *= np.float32(1e-20)
    elif name == "huge":
        g *= np.float32(1e20)
    elif name == "two_lengths":
        lengths = (641, 129)
    q = (rng.normal(size=(2, 200, 3)) * np.abs(g).max()).astype(np.float32)
    if name == "past_lengths":
        lengths = (700, 333)
        g[1, 333:] = np.float32(-1e30)
    return torch.tensor(g), torch.tensor(lengths), torch.tensor(q)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("name", ["random", "duplicated", "plane", "line", "tiny", "huge",
                                  "past_lengths", "two_lengths"])
def test_segment_bound_never_exceeds_a_member(name, norm):
    """``segment_bound`` (the kernel's box_distance, in its order of
    operations) is at most ``pairwise_dist`` from any query to any valid
    point of the segment, for queries at random, at the points themselves
    (bound 0) and on the boxes' faces and corners; each box holds exactly
    its segment's valid rows (none: an empty box), and the rows past
    lengths2 keep their place and widen no box."""
    p2, lengths, q = _bound_case(name)
    points, boxes = kk.screen_order_plain(p2, lengths)
    ids = kk.order_ids(points).long()
    P2 = p2.shape[1]
    seg = torch.arange(P2) // kk._SEGMENT
    gen = torch.Generator().manual_seed(3)
    for n in range(2):
        L = int(lengths[n])
        valid = torch.arange(P2) < L
        assert torch.equal(torch.sort(ids[n]).values, torch.arange(P2))
        assert torch.equal(ids[n, L:], torch.arange(L, P2))
        assert torch.equal(points[n, :, :3], p2[n, ids[n]])
        lo, hi, pts = boxes[n, :, :3], boxes[n, :, 4:7], points[n, :, :3]
        for s in range(boxes.shape[1]):
            members = pts[valid & (seg == s)]
            if len(members):
                assert torch.equal(lo[s], members.amin(0))
                assert torch.equal(hi[s], members.amax(0))
            else:
                assert (lo[s] == np.inf).all() and (hi[s] == -np.inf).all()
        pick = [torch.rand((len(lo), 3), generator=gen) < 0.5 for _ in range(3)]
        faces = torch.cat([torch.where(pick[0], lo, hi),
                           torch.where(pick[1], lo, q[n, :len(lo)]),
                           torch.where(pick[2], hi, q[n, -len(lo):])])
        queries = torch.cat([q[n], pts[valid], faces])
        queries = queries[torch.isfinite(queries).all(-1)]
        lb = kk.segment_bound(queries[:, None], lo[None], hi[None], norm)
        d = kk.pairwise_dist(queries, pts, norm)
        assert (lb[:, seg] <= d)[:, valid].all()
        inside = kk.segment_bound(pts[valid], lo[seg[valid]], hi[seg[valid]], norm)
        assert (inside == 0).all()


@pytest.mark.parametrize("at_seed", [False, True])
@pytest.mark.parametrize("norm", [1, 2])
def test_skip_equals_the_full_scan_and_the_rounds(monkeypatch, norm, at_seed):
    """A grid cloud (ties across the K-th slot) seeded at each query's
    exact K-th distance (``at_seed``: that candidate is left out, every
    query is flagged and repaired, and some segments' bounds equal the
    seed) or one float above it: the
    screen on its order, segments skipped, gives the flags and outputs of
    the full scan, and the call the unseeded rounds' result."""
    lengths = (P2, 1000, 700)
    p1, p2 = _clouds(9, levels=5)
    args = (_t(p1), _t(p2), _t(lengths))
    K = 100
    base = kk.knn_topk(*args, K, norm, sample_bound=False)
    wide = kk.knn_topk(*args, K + 1, norm, sample_bound=False)[0]
    assert (wide[..., K - 1] == wide[..., K]).any()
    kth = base[0][..., K - 1]
    seed = kth if at_seed else torch.nextafter(kth, torch.tensor(np.inf))
    tau = torch.nextafter(seed, torch.tensor(-np.inf))
    assert torch.equal(kk.seed_of(tau), seed)
    monkeypatch.setattr(kk, "kth_bounds", lambda *a, **kw: [tau])
    points, boxes = kk.screen_order_plain(args[1], args[2])
    lb = kk.segment_bound(args[0][:, :, None], boxes[:, None, :, :3], boxes[:, None, :, 4:7],
                          norm)
    assert (lb < seed[..., None]).float().mean() < 0.9  # the skip leaves segments out
    assert bool((lb == seed[..., None]).any()) == at_seed  # and bounds equal to the seed
    cap = kk.screen_cap(K, P2, S)
    R = kk._rounds(K, P2)
    outs = []
    for skips in (True, False):
        monkeypatch.setattr(kk, "_screen_skips", lambda D, skips=skips: skips)
        out = (torch.zeros((R, N, P1, kk.ROUND_K)),
               torch.zeros((R, N, P1, kk.ROUND_K), dtype=torch.int64))
        flags = kk._plain_screener(*args, norm)(K, seed, cap, out)
        outs.append((flags, *out))
        got = kk.knn_topk(*args, K, norm, sample_bound=True, sample_s=S)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert bool(outs[0][0].bool().all()) == at_seed
