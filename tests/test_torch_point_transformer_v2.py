"""Point Transformer V2 semantic segmentation (``pytorch3d_pointops_tpu_torch.models``)
and its grid pooling (``ops/grid_pool.py``, ``kernels/segment.py``) on the
CPU against the benchmark's plain reference
``benchmark/reference/point_transformer_v2_seg.py``: a small preset
(widths 16-64, groups 2-8, the published depths but one block at level 3,
neighbours 8 and 16, grids 0.1-0.8 m; every level present) on three ragged
clouds of 3,000, 2,400 and 2,000 points, and the published network on two
clouds of 2,500 and 2,000 points.

Tolerances, from float32 arithmetic in another order: the model's
``F.linear`` adds the bias inside one product where the reference adds it
after ``x @ W.T``, its gathers' backwards sum in another order than
autograd's indexing, and its grouped sum reduces in another order. Over the
network's layers that leaves at most a few 1e-7 of the largest logit and
1e-5 of a parameter's gradient norm on the seeds below; the tolerances are
1e-5 and 1e-4. A parameter whose gradient is zero in exact arithmetic has a
float32 gradient of rounding alone, of any size relative to its own tiny
exact value; only its being finite is checked. Those are the biases ahead
of a batch norm (q, k and the position and weight encodings' first layers,
both projections of an unpooling, the head's first layer), the bias of v
and of the position encoding's last layer, whose constant the attention's
weights (summing to 1) and the relation's batch norm pass on to a batch
norm, and the weight encoding's last bias, which the softmax takes away.
"""

import importlib.util
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from pytorch3d_pointops_tpu_torch import tracing
from pytorch3d_pointops_tpu_torch.kernels import segment
from pytorch3d_pointops_tpu_torch.models import (
    GridPoolLayer,
    GroupedVectorAttention,
    PointTransformerV2Seg,
    UnpoolWithSkip,
)
from pytorch3d_pointops_tpu_torch.models import point_transformer_v2
from pytorch3d_pointops_tpu_torch.ops import grid_pool, grid_pool_max

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
_spec = importlib.util.spec_from_file_location(
    "reference_point_transformer_v2_seg",
    os.path.join(REPO, "benchmark", "reference", "point_transformer_v2_seg.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SMALL = ref.Arch(patch_embed_channels=16, patch_embed_groups=2, enc_depths=(2, 2, 1, 2),
                 enc_channels=(16, 32, 32, 64), enc_groups=(2, 4, 4, 8),
                 dec_channels=(16, 16, 32, 32), dec_groups=(2, 2, 4, 4),
                 grid_sizes=(0.1, 0.2, 0.4, 0.8))
LENGTHS = [3000, 2400, 2000]
LOGITS_TOL = 1e-5  # of the largest reference logit
GRAD_TOL = 1e-4  # of each parameter's reference gradient norm


def model(seed, arch=SMALL):
    """The network with torch's initialisation and batch norm scales and
    shifts moved off 1 and 0."""
    torch.manual_seed(seed)
    m = PointTransformerV2Seg(**arch._asdict())
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.weight.add_(0.1 * torch.randn(mod.weight.shape, generator=g))
                mod.bias.add_(0.1 * torch.randn(mod.bias.shape, generator=g))
    return m


def clouds(seed, lengths=LENGTHS, pad=0.0, size=3.0):
    """Clouds in a box of ``size`` m with rgb in [-1, 1) and unit normals;
    ``pad`` fills past each length; labels of every valid point."""
    g = torch.Generator().manual_seed(seed)
    P = max(lengths)
    xyz = torch.rand((len(lengths), P, 3), generator=g) * size
    feats = torch.cat([torch.rand((len(lengths), P, 3), generator=g) * 2 - 1,
                       F.normalize(torch.randn((len(lengths), P, 3), generator=g), dim=-1)], -1)
    for n, length in enumerate(lengths):
        xyz[n, length:] = pad
        feats[n, length:] = pad
    labels = torch.randint(0, 20, (sum(lengths),), generator=g)
    return xyz, feats, labels


def port_plan(plan):
    """A port plan in the reference's order (``ref.plan_indices``)."""
    out = []
    for level in plan:
        p = level.pool
        if p is not None:
            out += [p.cluster, p.order, torch.tensor(p.lengths), p.pos]
        out += [level.neighbours[k][0] for k in sorted(level.neighbours)]
    return out


def zero_in_exact_arithmetic(exact):
    whole = torch.cat([g.flatten() for g in exact.values()])
    rms = float(whole.norm()) / whole.numel() ** 0.5
    return {n for n, g in exact.items() if float(g.norm()) <= 1e-9 * rms * g.numel() ** 0.5}


def null_by_design(name):
    """The biases whose gradient is zero in exact arithmetic."""
    return name.endswith((".linear_q.0.bias", ".linear_k.0.bias", ".linear_v.bias",
                          ".linear_p_bias.0.bias", ".linear_p_bias.3.bias",
                          ".linear_p_multiplier.0.bias", ".weight_encoding.0.bias",
                          ".weight_encoding.3.bias", ".proj.0.bias", ".proj_skip.0.bias")) \
        or name == "seg_head.0.bias"


@pytest.fixture(scope="module")
def small_case():
    xyz, feats, labels = clouds(1)
    m = model(1)
    plan = m.plan(xyz, LENGTHS)
    levels = ref.plan(xyz, LENGTHS, SMALL)
    return m, xyz, feats, labels, plan, levels


def test_plan_equals_the_reference(small_case):
    """Each pooling's clusters, order, counts by cloud and mean coordinates
    bit-equal, and every level's KNN (at level 0 both K, the reference's
    each computed on its own); every level present and each smaller than
    the one above."""
    m, _, _, _, plan, levels = small_case
    got, want = port_plan(plan), ref.plan_indices(levels)
    assert len(got) == len(want) == 4 * 4 + 6
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    sizes = [sum(level.lengths) for level in plan]
    assert sizes[0] == sum(LENGTHS) and all(a > b >= 16 * 3 for a, b in zip(sizes, sizes[1:]))
    for level, lv in zip(plan, levels, strict=True):
        assert level.lengths == lv["lengths"] and torch.equal(level.pos, lv["pos"])
        for k, (idx, rel) in level.neighbours.items():
            assert torch.equal(idx[:, 0], torch.arange(idx.shape[0]))  # itself first
            assert torch.equal(rel, level.pos[idx] - level.pos[:, None])
    assert sorted(plan[0].neighbours) == [8, 16]
    # The pooled features' offsets and the clusters agree.
    for level in plan[:-1]:
        p = level.pool
        assert torch.equal(p.cluster[p.order], torch.repeat_interleave(
            torch.arange(p.offsets.numel() - 1), p.offsets.diff()))


def test_logits_loss_and_gradients_match_the_reference(small_case):
    """With the model's own drop path masks handed to both."""
    m, xyz, feats, labels, plan, levels = small_case
    m.zero_grad()
    masks = m.drop_masks(plan, torch.Generator().manual_seed(7))
    assert masks and all(t.shape == (sum(plan[m.block_levels()[n]].lengths),)
                         for n, t in masks.items())
    weights = {k: v.clone() for k, v in m.state_dict().items()}
    want, want_loss, want_grads, _, _ = ref.step(weights, xyz, feats, LENGTHS, labels, masks,
                                                 levels, arch=SMALL)
    exact = ref.step(weights, xyz, feats, LENGTHS, labels, masks, levels, torch.float64,
                     arch=SMALL)[2]
    logits = m(xyz, feats, LENGTHS, plan, masks)
    loss = F.cross_entropy(logits, labels)
    loss.backward()

    assert logits.shape == (sum(LENGTHS), 20)
    assert float((logits.detach() - want).abs().max()) <= LOGITS_TOL * float(want.abs().max())
    assert abs(loss.item() - want_loss) <= 1e-6 * want_loss
    nulls = zero_in_exact_arithmetic(exact)
    assert nulls == {n for n in want_grads if null_by_design(n)}
    grads = dict(m.named_parameters())
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        got = grads[name].grad
        if name in nulls:
            assert bool(torch.isfinite(got).all()), name
        else:
            assert float((got - g).norm()) <= GRAD_TOL * float(g.norm()), name
    # Without the masks the logits move: the masks were applied.
    with torch.no_grad():
        assert not torch.equal(m(xyz, feats, LENGTHS, plan, {}), logits.detach())


def test_the_pe_multiplier_path():
    arch = SMALL._replace(pe_multiplier=True, enc_depths=(1, 1, 1, 1))
    xyz, feats, labels = clouds(2, [2500, 2000])
    m = model(2, arch)
    assert all(hasattr(b.attn, "linear_p_multiplier") for s in m.enc_stages
               for b in s.blocks.blocks)
    plan = m.plan(xyz, [2500, 2000])
    levels = ref.plan(xyz, [2500, 2000], arch)
    weights = {k: v.clone() for k, v in m.state_dict().items()}
    want, want_loss, want_grads, _, _ = ref.step(weights, xyz, feats, [2500, 2000], labels, {},
                                                 levels, arch=arch)
    exact = ref.step(weights, xyz, feats, [2500, 2000], labels, {}, levels, torch.float64,
                     arch=arch)[2]
    m.eval()  # no drop path; batch norm then uses running statistics: train again
    m.train()
    logits = m(xyz, feats, [2500, 2000], plan, {})
    F.cross_entropy(logits, labels).backward()
    assert float((logits.detach() - want).abs().max()) <= LOGITS_TOL * float(want.abs().max())
    nulls = zero_in_exact_arithmetic(exact)
    assert nulls == {n for n in want_grads if null_by_design(n)}
    assert any("linear_p_multiplier.3" in n for n in want_grads)
    for name, g in want_grads.items():
        if name not in nulls:
            got = dict(m.named_parameters())[name].grad
            assert float((got - g).norm()) <= GRAD_TOL * float(g.norm()), name


def test_published_widths_plan_and_logits():
    lengths = [2500, 2000]
    xyz, feats, _ = clouds(3, lengths, size=6.0)
    m = model(3, ref.PUBLISHED)
    assert m.grid_sizes == point_transformer_v2.GRID_SIZES
    assert [s.blocks.neighbours for s in m.enc_stages] == list(point_transformer_v2.ENC_NEIGHBOURS)
    assert [len(s.blocks.blocks) for s in m.enc_stages] == list(point_transformer_v2.ENC_DEPTHS)
    plan = m.plan(xyz, lengths)
    levels = ref.plan(xyz, lengths)
    for a, b in zip(port_plan(plan), ref.plan_indices(levels), strict=True):
        assert torch.equal(a, b)
    with torch.no_grad():
        logits = m(xyz, feats, lengths, plan, {})
        want = ref.forward(m.state_dict(), xyz, feats, lengths, levels)[0]
    assert float((logits - want).abs().max()) <= LOGITS_TOL * float(want.abs().max())


def test_groups_are_contiguous_channel_blocks():
    """y_i[c] = sum_j (v_j + peb)[c] * w[j, c // (C/G)], written out with
    explicit indices, against the layer."""
    torch.manual_seed(4)
    C, G, T, K = 24, 4, 30, 5
    layer = GroupedVectorAttention(C, G).train()
    x = torch.randn(T, C)
    idx = torch.stack([(torch.arange(T) + j) % T for j in range(K)], 1)
    rel = torch.randn(T, K, 3)
    with torch.no_grad():
        y = layer(x, idx, rel)
        q, k, v = layer.linear_q(x), layer.linear_k(x)[idx], layer.linear_v(x)[idx]
        peb = layer.linear_p_bias(rel)
        w = layer.weight_encoding(k - q[:, None] + peb).softmax(1)
        group = torch.arange(C) // (C // G)
        want = ((v + peb) * w[:, :, group]).sum(1)
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-6)


def test_drop_path_rates_are_the_sources_linspace():
    m = PointTransformerV2Seg()
    rates = m.drop_path_rates()
    enc = torch.linspace(0, 0.3, 12).tolist()
    names = [f"enc_stages.{i}.blocks.blocks.{b}" for i, d in enumerate((2, 2, 6, 2))
             for b in range(d)]
    want = {n: r for n, r in zip(names, enc) if r > 0}
    want.update({f"dec_stages.{i}.blocks.blocks.0": r
                 for i, r in enumerate(torch.linspace(0, 0.3, 4).tolist()) if r > 0})
    assert rates == want == ref.drop_path_rates(ref.PUBLISHED)
    assert len(rates) == 11 + 3 and not any(n.startswith("patch_embed") for n in rates)


def test_drop_masks_keep_rows_at_their_rate(small_case):
    m, _, _, _, plan, _ = small_case
    masks = m.drop_masks(plan, torch.Generator().manual_seed(8))
    for name, mask in masks.items():
        keep = 1.0 - m.drop_path_rates()[name]
        assert set(mask.unique().tolist()) <= {0.0, float(torch.tensor(1.0) / keep)}
    # A module in training mode draws its own; in eval mode drops nothing.
    xyz, feats, _ = clouds(1)
    with torch.no_grad():
        m.eval()
        a = m(xyz, feats, LENGTHS, plan)
        b = m(xyz, feats, LENGTHS, plan, {})
        m.train()
    assert torch.equal(a, b)


def test_padding_values_change_nothing():
    runs = []
    for pad in (0.0, 123.0):
        xyz, feats, labels = clouds(5, pad=pad)
        m = model(5)
        plan = m.plan(xyz, LENGTHS)
        logits = m(xyz, feats, LENGTHS, plan, {})
        F.cross_entropy(logits, labels).backward()
        runs.append((port_plan(plan), logits.detach(),
                     {n: p.grad for n, p in m.named_parameters()}))
    (i0, l0, g0), (i1, l1, g1) = runs
    assert all(torch.equal(a, b) for a, b in zip(i0, i1, strict=True))
    assert torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.parametrize("lengths, level", [([3000, 10], 0), ([3000, 300], 4)])
def test_a_cloud_below_k_raises(lengths, level):
    """A cloud of 10 points is below level 0's 16; one of 300 points in a
    3 m box keeps fewer than 16 clusters at level 4's 0.8 m grid."""
    xyz, _, _ = clouds(6, lengths, size=1.0 if level == 4 else 3.0)
    with pytest.raises(ValueError, match=f"level {level} needs"):
        model(6).plan(xyz, lengths)
    with pytest.raises(ValueError):
        ref.plan(xyz, lengths, SMALL)


def test_spans_counters_and_host_reads(small_case):
    m, xyz, feats, labels, _, _ = small_case
    tracing.clear()
    try:
        with tracing.recording():
            plan = m.plan(xyz, LENGTHS)
            F.cross_entropy(m(xyz, feats, LENGTHS, plan, {}), labels).backward()
        syncs = tracing.counts("sync.")
        records = tracing.records()
        counts = tracing.counts("point_transformer_v2.")
        clusters = tracing.counts("grid_pool.")
    finally:
        tracing.clear()
    names = [r.name for r in records]
    blocks = 1 + sum(SMALL.enc_depths) + sum(SMALL.dec_depths)
    assert syncs == {"sync.grid_pool.counts": 4}
    assert names.count("point_transformer_v2.plan") == 1
    assert names.count("grid_pool") == 4 and names.count("grid_pool_max") == 4
    assert names.count("point_transformer_v2.pool") == 4
    assert names.count("point_transformer_v2.attn") == blocks
    assert names.count("point_transformer_v2.unpool") == 4
    assert names.count("point_transformer_v2.head") == 1
    assert names.count("GridPool.bwd") == 4
    (root,) = [r for r in records if r.name == "point_transformer_v2.plan"]
    inside = [r.name for r in records if r.parent == root.id and r.name != "masked_gather"]
    assert inside == ["grid_pool"] * 4 + ["knn_points"] * 5
    T = [sum(level.lengths) for level in plan]
    assert clusters == {"grid_pool.clusters": sum(T[1:])}
    rows = sum(T[lv] * K for _, lv, _, _, K in ref.blocks(SMALL)) + sum(T[:4])
    assert counts == {"point_transformer_v2.grouped_rows": rows}


def test_the_modules_keep_the_source_names():
    m = model(9)
    names = set(m.state_dict())
    for name in ("patch_embed.proj.0.weight", "patch_embed.proj.1.norm.running_var",
                 "patch_embed.blocks.blocks.0.attn.linear_q.0.bias",
                 "enc_stages.0.down.fc.weight", "enc_stages.0.down.norm.norm.weight",
                 "enc_stages.3.blocks.blocks.1.attn.weight_encoding.3.weight",
                 "enc_stages.1.blocks.blocks.0.attn.linear_p_bias.1.norm.weight",
                 "dec_stages.0.up.proj.0.bias", "dec_stages.2.up.proj_skip.1.norm.bias",
                 "dec_stages.3.blocks.blocks.0.fc3.weight", "seg_head.3.bias"):
        assert name in names, name
    assert "enc_stages.0.down.fc.bias" not in names
    assert "patch_embed.blocks.blocks.0.fc1.bias" not in names
    assert isinstance(m.enc_stages[0].down, GridPoolLayer)
    assert isinstance(m.dec_stages[0].up, UnpoolWithSkip)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="one entry a stage"):
        PointTransformerV2Seg(enc_depths=(2, 2, 6))
    with pytest.raises(ValueError, match="multiple of groups"):
        GroupedVectorAttention(20, 6)
    m = model(10)
    xyz, feats, _ = clouds(10)
    plan = m.plan(xyz, LENGTHS)
    with pytest.raises(ValueError, match="other lengths"):
        m(xyz, feats, [3000, 2400, 1999], plan)


# --- grid pooling and its segment kernels (their plain twins here) ---


def test_grid_pool_matches_the_reference_on_ragged_clouds():
    """Clouds of 0, 1, 700 and 64 points (the last all in one voxel): the
    clusters, order, counts and means bit-equal to the reference's; the
    numbering is torch.unique's over grid_cluster's key."""
    g = torch.Generator().manual_seed(11)
    lengths = [0, 1, 700, 64]
    pos = torch.cat([torch.rand(1, 3, generator=g), torch.rand(700, 3, generator=g) * 2,
                     0.5 + 0.01 * torch.rand(64, 3, generator=g)])
    got = grid_pool(pos, lengths, 0.25)
    want = ref.grid_pool(pos, lengths, 0.25)
    assert got.lengths == want["lengths"] and got.lengths[:2] == [0, 1] and got.lengths[3] == 1
    for a, b in ((got.cluster, want["cluster"]), (got.order, want["order"]),
                 (got.offsets, want["offsets"]), (got.pos, want["pos"])):
        assert torch.equal(a, b)
    cloud = torch.repeat_interleave(torch.arange(4), torch.tensor(lengths))
    start = torch.stack([pos[1:2].amin(0)] * 2 + [pos[1:701].amin(0), pos[701:].amin(0)])
    v = ((pos - start[cloud]) / 0.25).floor().to(torch.int64)
    key = ((cloud * 100 + v[:, 2]) * 100 + v[:, 1]) * 100 + v[:, 0]
    _, inverse = torch.unique(key, sorted=True, return_inverse=True)
    assert torch.equal(got.cluster, inverse)
    acc = torch.zeros(3)
    for row in pos[701:]:  # the rows in order, one add at a time
        acc = acc + row
    assert torch.equal(got.pos[got.cluster[701]], acc / 64)


def test_grid_pool_max_keeps_the_first_of_equal_maxima():
    pos = torch.tensor([[0.0, 0, 0], [0.1, 0, 0], [0.05, 0, 0], [0.9, 0, 0]])
    pool = grid_pool(pos, [4], 0.5)
    assert pool.lengths == [2] and pool.order.tolist() == [0, 1, 2, 3]
    x = torch.tensor([[1.0, 5.0], [3.0, 5.0], [3.0, 2.0], [7.0, 7.0]], requires_grad=True)
    y = grid_pool_max(x, pool)
    assert y.tolist() == [[3.0, 5.0], [7.0, 7.0]]
    y.backward(torch.tensor([[10.0, 20.0], [30.0, 40.0]]))
    assert x.grad.tolist() == [[0.0, 20.0], [10.0, 0.0], [0.0, 0.0], [30.0, 40.0]]


def test_grid_pool_max_backward_by_gradcheck():
    g = torch.Generator().manual_seed(12)
    lengths = [40, 0, 25]
    pool = grid_pool(torch.rand(65, 3, generator=g), lengths, 0.4)
    x = torch.randn(65, 3, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: grid_pool_max(t, pool), (x,))


@pytest.mark.parametrize("bad", ["far", "nan"])
def test_grid_pool_refuses_what_the_keys_cannot_hold(bad):
    pos = torch.rand(10, 3)
    pos[3, 1] = 1e6 if bad == "far" else float("nan")
    with pytest.raises(ValueError, match="2\\^17"):
        grid_pool(pos, [10], 0.01)


def test_segment_twins_against_loops():
    g = torch.Generator().manual_seed(13)
    T, C = 50, 3
    x = torch.randn(T, C, generator=g)
    x[7] = x[8]  # a tie
    order = torch.randperm(T, generator=g)
    offsets = torch.tensor([0, 1, 9, 30, 50])
    total, best, arg = [], [], []
    for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
        rows = order[a:b].tolist()
        acc = torch.zeros(C)
        for r in rows:
            acc = acc + x[r]
        total.append(acc)
        m = [max(range(len(rows)), key=lambda k: (x[rows[k], c].item(), -k)) for c in range(C)]
        best.append(torch.stack([x[rows[k], c] for c, k in enumerate(m)]))
        arg.append(torch.tensor([rows[k] for k in m], dtype=torch.int32))
    assert torch.equal(segment.segment_sum(x, order, offsets), torch.stack(total))
    assert torch.equal(segment.segment_sum(x, order, offsets, mean=True),
                       torch.stack(total) / offsets.diff()[:, None].float())
    out, rows = segment.segment_max(x, order, offsets)
    assert torch.equal(out, torch.stack(best)) and torch.equal(rows, torch.stack(arg))
    heads = torch.tensor([1, 0, 1, 1, 0, 0])  # of sorted keys 3, 3, 5, 9, 9, 9
    counts = torch.zeros(2, dtype=torch.int64)
    off, cluster = segment.segment_bounds(torch.cumsum(heads, 0), torch.arange(6),
                                          torch.tensor([2, 6]), 7, counts)
    assert off[:4].tolist() == [0, 2, 3, 6] and cluster.tolist() == [0, 0, 1, 2, 2, 2]
    assert counts.tolist() == [1, 3]
