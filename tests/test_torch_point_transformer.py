"""Point Transformer semantic segmentation (``pytorch3d_pointops_tpu_torch.models``)
on the CPU against the benchmark's plain reference
``benchmark/reference/point_transformer_seg.py``: a small preset (widths 16,
16, 32, 32, 64; nsample 4, 8, 8, 8, 8; strides 1, 2, 2, 2, 2; the published
blocks) on two ragged clouds of 300 and 271 points, and the published
network on clouds of 4,096 and 5,000 points.

Tolerances, from float32 arithmetic in another order: the model's
``F.linear`` adds the bias inside one product where the reference adds it
after ``x @ W.T``, its gathers' backwards sum in another order than
autograd's indexing, and its interpolation sums the three neighbours in one
reduction. Over the network's 40-odd layers that leaves at most 1.6e-6 of
the largest logit and 1.0e-5 of a parameter's gradient norm on the seeds
below; the tolerances are 1e-5 and 1e-4. A parameter whose gradient is zero
in exact arithmetic (every bias ahead of a batch norm, the biases of v and
of the position encoding, whose constant the attention's weights, summing
to 1, pass to the next batch norm, and the weight encoding's last bias,
which the softmax takes away; their float64 gradient reads below 1e-9 of
the rest) has a float32 gradient of rounding alone, of any size relative to
its own tiny exact value; only its being finite is checked.
"""

import importlib.util
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from pytorch3d_pointops_tpu_torch import tracing
from pytorch3d_pointops_tpu_torch.models import (
    PointTransformerBlock,
    PointTransformerLayer,
    PointTransformerSeg,
    TransitionDown,
    TransitionUp,
)
from pytorch3d_pointops_tpu_torch.models import point_transformer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
_spec = importlib.util.spec_from_file_location(
    "reference_point_transformer_seg",
    os.path.join(REPO, "benchmark", "reference", "point_transformer_seg.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SMALL = ref.Arch(planes=(16, 16, 32, 32, 64), nsample=(4, 8, 8, 8, 8), strides=(1, 2, 2, 2, 2))
LENGTHS = [300, 271]
LOGITS_TOL = 1e-5  # of the largest reference logit
GRAD_TOL = 1e-4  # of each parameter's reference gradient norm


def model(seed, arch=SMALL):
    """The network with torch's initialisation and batch norm scales and
    shifts moved off 1 and 0."""
    torch.manual_seed(seed)
    m = PointTransformerSeg(in_channels=arch.in_channels, classes=arch.classes,
                            planes=arch.planes, strides=arch.strides, nsample=arch.nsample,
                            blocks=arch.blocks, share_planes=arch.share_planes)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, mod in m.named_modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.weight.add_(0.1 * torch.randn(mod.weight.shape, generator=g))
                mod.bias.add_(0.1 * torch.randn(mod.bias.shape, generator=g))
    return m


def clouds(seed, lengths=LENGTHS, pad=0.0):
    """Clouds in a 3 m box with colours in [0, 1); ``pad`` fills past each
    length; labels of every valid point."""
    g = torch.Generator().manual_seed(seed)
    P = max(lengths)
    xyz = torch.rand((len(lengths), P, 3), generator=g) * 3
    rgb = torch.rand((len(lengths), P, 3), generator=g)
    for n, length in enumerate(lengths):
        xyz[n, length:] = pad
        rgb[n, length:] = pad
    labels = torch.randint(0, 13, (sum(lengths),), generator=g)
    return xyz, rgb, labels


def zero_in_exact_arithmetic(exact):
    whole = torch.cat([g.flatten() for g in exact.values()])
    rms = float(whole.norm()) / whole.numel() ** 0.5
    return {n for n, g in exact.items() if float(g.norm()) <= 1e-9 * rms * g.numel() ** 0.5}


def ahead_of_a_norm(name):
    """The biases whose gradient is zero in exact arithmetic."""
    attention = (".linear_q.bias", ".linear_k.bias", ".linear_v.bias", ".linear_p.0.bias",
                 ".linear_p.3.bias", ".linear_w.2.bias", ".linear_w.5.bias")
    up = name.startswith("dec") and (".0.linear1.0.bias" in name or ".0.linear2.0.bias" in name)
    head_mean = name == "dec5.0.linear2.0.bias"
    return name.endswith(attention) or (up and not head_mean) or name == "cls.0.bias"


@pytest.fixture(scope="module")
def small_case():
    xyz, rgb, labels = clouds(1)
    m = model(1)
    plan = m.plan(xyz, LENGTHS)
    levels = ref.plan(xyz, LENGTHS, SMALL)
    return m, xyz, rgb, labels, plan, levels


def port_indices(plan):
    return [t for level in plan for t in (level.fps_idx, level.down_idx, level.nbr_idx,
                                          level.up_idx) if t is not None]


def test_plan_equals_the_reference(small_case):
    m, xyz, _, _, plan, levels = small_case
    got, want = port_indices(plan), ref.plan_indices(levels)
    assert len(got) == len(want) == 4 * 5 - 3
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    for level, lv in zip(plan, levels, strict=True):
        assert level.lengths == lv["lengths"]
        assert torch.equal(level.pos, lv["pos"])
    for level, lv in zip(plan[:-1], levels[:-1]):
        assert torch.equal(level.up_dist, lv["up_d2"])
    # Each point is its own nearest neighbour; FPS starts at each cloud's first point.
    for level in plan:
        assert torch.equal(level.nbr_idx[:, 0], torch.arange(sum(level.lengths)))
    assert plan[1].fps_idx[:, 0].tolist() == [0, 0]


def test_logits_loss_and_gradients_match_the_reference(small_case):
    m, xyz, rgb, labels, plan, levels = small_case
    m.zero_grad()
    weights = {k: v.clone() for k, v in m.state_dict().items()}
    want, want_loss, want_grads, _, _ = ref.step(weights, xyz, rgb, LENGTHS, labels, levels,
                                                 arch=SMALL)
    exact = ref.step(weights, xyz, rgb, LENGTHS, labels, levels, torch.float64, arch=SMALL)[2]
    logits = m(xyz, rgb, LENGTHS, plan)
    loss = F.cross_entropy(logits, labels)
    loss.backward()

    assert logits.shape == (sum(LENGTHS), 13)
    assert float((logits.detach() - want).abs().max()) <= LOGITS_TOL * float(want.abs().max())
    assert abs(loss.item() - want_loss) <= 1e-6 * want_loss
    nulls = zero_in_exact_arithmetic(exact)
    assert nulls == {n for n in want_grads if ahead_of_a_norm(n)}
    grads = dict(m.named_parameters())
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        got = grads[name].grad
        if name in nulls:
            assert bool(torch.isfinite(got).all()), name
        else:
            assert float((got - g).norm()) <= GRAD_TOL * float(g.norm()), name


def test_published_widths_plan_and_logits():
    lengths = [4096, 5000]
    xyz, rgb, _ = clouds(2, lengths)
    m = model(2, ref.PUBLISHED)
    assert (m.planes, m.strides, m.nsample, m.blocks) == (
        point_transformer.PLANES, point_transformer.STRIDES, point_transformer.NSAMPLE,
        point_transformer.BLOCKS)
    plan = m.plan(xyz, lengths)
    assert [level.lengths for level in plan] == [[4096, 5000], [1024, 1250], [256, 312],
                                                 [64, 78], [16, 19]]
    levels = ref.plan(xyz, lengths)
    for a, b in zip(port_indices(plan), ref.plan_indices(levels), strict=True):
        assert torch.equal(a, b)
    with torch.no_grad():
        logits = m(xyz, rgb, lengths, plan)
        want = ref.forward(m.state_dict(), xyz, rgb, lengths, levels)[0]
    assert float((logits - want).abs().max()) <= LOGITS_TOL * float(want.abs().max())


def test_channel_c_takes_weight_column_c_mod_c_over_8():
    """y_i[c] = sum_j (v_j + p_r)[c] * w[j, c mod (C/8)], written out with
    explicit indices, against the layer."""
    torch.manual_seed(3)
    C, T, K = 32, 20, 4
    layer = PointTransformerLayer(C).train()
    x = torch.randn(T, C)
    nbr = torch.stack([(torch.arange(T) + j) % T for j in range(K)], 1)
    pos = torch.randn(T, 3)
    rel = pos[nbr] - pos[:, None]
    level = point_transformer.Level([T], None, None, pos, None, None, None, nbr, rel, None, None)
    with torch.no_grad():
        y = layer(x, level)
        lp, lw = layer.linear_p, layer.linear_w
        q, k, v = layer.linear_q(x), layer.linear_k(x)[nbr], layer.linear_v(x)[nbr]
        p = lp(rel.reshape(-1, 3)).reshape(T, K, C)
        w = lw((k - q[:, None] + p).reshape(-1, C)).reshape(T, K, C // 8).softmax(1)
        column = torch.arange(C) % (C // 8)
        want = ((v + p) * w[:, :, column]).sum(1)
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-6)


def test_padding_values_change_nothing():
    """Padding coordinates and colours of 0 or 123: the same plan, logits,
    batch statistics and gradients, bit for bit."""
    runs = []
    for pad in (0.0, 123.0):
        xyz, rgb, labels = clouds(4, pad=pad)
        m = model(4)
        plan = m.plan(xyz, LENGTHS)
        logits = m(xyz, rgb, LENGTHS, plan)
        F.cross_entropy(logits, labels).backward()
        runs.append((port_indices(plan), logits.detach(), m.state_dict(),
                     {n: p.grad for n, p in m.named_parameters()}))
    (i0, l0, s0, g0), (i1, l1, s1, g1) = runs
    assert all(torch.equal(a, b) for a, b in zip(i0, i1, strict=True))
    assert torch.equal(l0, l1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.parametrize("lengths, level", [([300, 3], 1), ([300, 15], 2), ([300, 127], 5)])
def test_a_cloud_below_nsample_raises(lengths, level):
    """At the small preset a cloud of 3 points is below level 1's nsample
    of 4; one of 15 keeps 7 points at level 2 and one of 127 keeps 7 at
    level 5, below their 8."""
    xyz, _, _ = clouds(5, lengths)
    with pytest.raises(ValueError, match=f"level {level} needs"):
        model(5).plan(xyz, lengths)
    with pytest.raises(ValueError, match=f"level {level} needs"):
        ref.plan(xyz, lengths, SMALL)


def test_spans_counter_and_no_host_read(small_case):
    m, xyz, rgb, labels, _, _ = small_case
    tracing.clear()
    try:
        with tracing.recording():
            plan = m.plan(xyz, LENGTHS)
            F.cross_entropy(m(xyz, rgb, LENGTHS, plan), labels).backward()
        assert tracing.counts("sync.") == {}
        records = tracing.records()
        rows = tracing.counts("point_transformer.")
    finally:
        tracing.clear()
    names = [r.name for r in records]
    levels = len(SMALL.planes)
    assert names.count("point_transformer.plan") == 1
    assert names.count("point_transformer.down") == levels
    assert names.count("point_transformer.attn") == sum(SMALL.blocks) + levels
    assert names.count("point_transformer.up") == levels
    assert names.count("point_transformer.head") == 1
    (root,) = [r for r in records if r.name == "point_transformer.plan"]
    inside = [r.name for r in records if r.parent == root.id and r.name != "masked_gather"]
    # Level 1: its self-KNN; levels 2-5: FPS, the down KNN, the self-KNN;
    # then the 3 nearest coarser points of levels 1-4.
    assert inside == (["knn_points"] + ["sample_farthest_points", "knn_points", "knn_points"] * 4
                      + ["knn_points"] * 4)
    T = [sum(level.lengths) for level in plan]
    K = SMALL.nsample
    attn = sum((b + 1) * t * k for b, t, k in zip(SMALL.blocks, T, K))
    down = sum(t * k for t, k in zip(T[1:], K[1:]))
    up = sum(3 * t for t in T[:-1])
    assert rows == {"point_transformer.grouped_rows": attn + down + up}


def test_the_modules_keep_the_source_names():
    names = set(model(6).state_dict())
    for name in ("enc1.0.linear.weight", "enc2.0.linear.weight", "enc5.2.transformer2.linear_w.5.bias",
                 "enc4.5.bn3.running_var", "dec5.0.linear2.0.weight", "dec1.0.linear2.1.weight",
                 "dec1.1.transformer2.linear_p.3.weight", "cls.3.bias"):
        assert name in names, name
    assert "enc1.0.linear.bias" not in names and "enc5.3.linear1.weight" not in names
    assert isinstance(model(6).enc2[0], TransitionDown)
    assert isinstance(model(6).dec5[0], TransitionUp) and isinstance(model(6).dec5[1],
                                                                        PointTransformerBlock)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="strides"):
        PointTransformerSeg(strides=(2, 4, 4, 4, 4))
    with pytest.raises(ValueError, match="multiple of share_planes"):
        PointTransformerLayer(20)
    m = model(7)
    xyz, rgb, _ = clouds(7)
    plan = m.plan(xyz, LENGTHS)
    with pytest.raises(ValueError, match="other lengths"):
        m(xyz, rgb, [300, 270], plan)
