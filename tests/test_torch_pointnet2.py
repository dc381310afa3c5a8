"""PointNet++ SSG classification (``pytorch3d_pointops_tpu_torch.models``)
on the CPU, as published (npoint 512 / 128, nsample 32 / 64), on four
clouds of 450-640 points (one shorter than SA1's 512 centres), against the
benchmark's plain reference ``benchmark/reference/pointnet2_ssg.py``.

Tolerances, from float32 arithmetic in another order: the reference's
matrix products are ``x @ W.T + b`` where the model's ``F.linear`` adds the
bias inside one product, and its gathers' backwards sum in another order
than the port's scatter; its batch norm is torch's, as the model's. Over
the network's eleven layers that leaves at most 1.7e-6 of the largest
logit and 3.7e-5 of a parameter's gradient norm on the seeds below; the
tolerances are 1e-5 and 1e-4. A parameter whose gradient is zero in exact arithmetic (a bias
ahead of a batch norm, SA3's last batch norm shift: the float64 gradient
reads below 1e-9 of the rest) has a float32 gradient of rounding alone,
which in SA1's first bias, ahead of a batch norm over centred coordinates
and padding rows, reaches many times the whole gradient's root mean
square; only its being finite is checked.
"""

import importlib.util
import os

import pytest
import torch
import torch.nn.functional as F

from pytorch3d_pointops_tpu_torch import tracing
from pytorch3d_pointops_tpu_torch.models import PointNet2ClsSSG, SetAbstraction
from pytorch3d_pointops_tpu_torch.models import pointnet2

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_pointnet2_ssg", os.path.join(REPO, "benchmark", "reference", "pointnet2_ssg.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
LENGTHS = [640, 600, 611, 450]
LOGITS_TOL = 1e-5  # of the largest reference logit
GRAD_TOL = 1e-4  # of each parameter's reference gradient norm


def clouds(seed, lengths=LENGTHS, P=640, pad=0.0):
    """Gaussian clouds of about unit radius; ``pad`` fills past each length."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn((len(lengths), P, 3), generator=g) * 0.5
    for n, length in enumerate(lengths):
        xyz[n, length:] = pad
    return xyz, torch.tensor(lengths)


def model(seed):
    """The classifier with torch's initialisation and batch norm scales and
    shifts moved off 1 and 0."""
    torch.manual_seed(seed)
    m = PointNet2ClsSSG()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in m.named_parameters():
            if ".norms." in name or name.startswith("bn"):
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return m


def pre_norm_bias(name):
    return name.endswith(".bias") and (".linears." in name or name in ("fc1.bias", "fc2.bias"))


def zero_in_exact_arithmetic(exact):
    """Names of the parameters whose float64 gradient is below 1e-9 of the
    whole gradient's root mean square, and that root mean square."""
    whole = torch.cat([g.flatten() for g in exact.values()])
    rms = float(whole.norm()) / whole.numel() ** 0.5
    return {n for n, g in exact.items() if float(g.norm()) <= 1e-9 * rms * g.numel() ** 0.5}, rms


def reference_step(m, xyz, labels, seed, dtype=torch.float32):
    """The reference's logits, loss and gradients, in ``dtype``, at the
    model's weights, with the masks the model draws from ``seed``."""
    state = m.state_dict()
    weights = {k: v.to(dtype).requires_grad_(True) for k, v in state.items()
               if ref.is_parameter(k)}
    stats = {k: v.to(dtype).clone() for k, v in state.items() if k.endswith(ref.STATS)}
    masks = ref.draw_masks(len(LENGTHS), torch.Generator().manual_seed(seed), "cpu")
    lg = ref.logits(weights, stats, xyz.to(dtype), ref.plan(xyz, LENGTHS), masks)
    loss = F.cross_entropy(lg, labels)
    return lg.detach(), loss, dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))


def test_plan_equals_the_reference():
    xyz, lengths = clouds(0)
    got = model(0).plan(xyz, lengths)
    want = ref.plan(xyz, LENGTHS)
    for level, (idx, centres, group) in zip(got, want, strict=True):
        assert torch.equal(level.fps_idx, idx)
        assert torch.equal(level.centres, centres)
        assert torch.equal(level.group_idx, group)
    # The short cloud's SA1 padding centres have empty groups; every other
    # group's slots are all filled.
    assert bool((got[0].group_idx[3, 450:] == -1).all())
    assert bool((got[0].group_idx[:3] >= 0).all()) and bool((got[1].group_idx >= 0).all())


@pytest.mark.parametrize("seed", [1, 2])
def test_logits_loss_and_gradients_match_the_reference(seed):
    xyz, lengths = clouds(seed)
    m = model(seed)
    labels = torch.randint(0, 40, (len(LENGTHS),), generator=torch.Generator().manual_seed(seed))
    want, want_loss, want_grads = reference_step(m, xyz, labels, seed)
    exact = reference_step(m, xyz, labels, seed, torch.float64)[2]
    logits = m(xyz, lengths, generator=torch.Generator().manual_seed(seed))
    loss = F.cross_entropy(logits, labels)
    loss.backward()

    logits = logits.detach()
    assert float((logits - want).abs().max()) <= LOGITS_TOL * float(want.abs().max())
    assert abs(loss.item() - want_loss.item()) <= 1e-6 * want_loss.item()
    nulls, _ = zero_in_exact_arithmetic(exact)
    assert {n for n in want_grads if pre_norm_bias(n)} <= nulls
    assert nulls <= {n for n in want_grads if pre_norm_bias(n) or n.endswith("norms.2.bias")}
    grads = dict(m.named_parameters())
    for name, g in want_grads.items():
        got = grads[name].grad
        if name in nulls:
            assert bool(torch.isfinite(got).all()), name
        else:
            assert float((got - g).norm()) <= GRAD_TOL * float(g.norm()), name


def test_running_statistics_and_first_update_match_the_reference():
    """One training step of the model with torch's Adam, as the benchmark
    takes it, against the reference's ``first_step`` from the same state:
    each batch norm's running statistics, and Adam's first update of every
    parameter whose gradient is not zero in exact arithmetic (an entry
    moves by lr times the sign of its gradient, so only entries within
    rounding of zero may differ, and hardly any do)."""
    xyz, lengths = clouds(8)
    m = model(8)
    labels = torch.randint(0, 40, (len(LENGTHS),), generator=torch.Generator().manual_seed(8))
    start = {k: v.clone() for k, v in m.state_dict().items()}
    inputs = {"weights": start, "dropout_seed": 11, "lr": 1e-3,
              "clouds": [{"xyz": xyz, "lengths_host": LENGTHS, "labels": labels}]}
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    F.cross_entropy(m(xyz, lengths, generator=torch.Generator().manual_seed(11)), labels).backward()
    opt.step()
    want = ref.first_step(inputs)
    exact = ref.exact_gradient(inputs)
    nulls, rms = zero_in_exact_arithmetic(exact)
    after = m.state_dict()
    for name, change in want["change"].items():
        got = after[name].double() - start[name].double()
        if name.endswith(ref.STATS):
            assert float((got - change).norm()) <= 1e-5 * float(change.norm()), name
        elif name not in nulls:
            moved = exact[name].abs() > 1e-9 * rms
            flips = int(((got * change) < 0)[moved].sum())
            assert flips <= 1e-3 * int(moved.sum()), name


def test_forward_plans_as_plan_does():
    """forward(xyz, lengths) equals forward with the plan given, bit for bit."""
    xyz, lengths = clouds(3)
    m = model(3)
    a = m(xyz, lengths, generator=torch.Generator().manual_seed(5))
    b = m(xyz, lengths, m.plan(xyz, lengths), torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_a_ball_short_of_nsample_repeats_slot_0():
    """Point 0 (the first centre) has two neighbours within 0.2; the rest
    lie 5 away. Its group is the three points in scan order, then point 0
    again, as ``query_ball_point`` fills it."""
    far = torch.randn((1, 20, 3), generator=torch.Generator().manual_seed(0))
    far = 5.0 * far / far.norm(dim=-1, keepdim=True)
    near = torch.tensor([[[0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0]]])
    xyz = torch.cat([near[:, :1], far[:, :5], near[:, 1:2], far[:, 5:], near[:, 2:]], 1)
    level, held = SetAbstraction(0, (64,), npoint=4, radius=0.2, nsample=8).sample(xyz, None)
    assert held is None and int(level.fps_idx[0, 0]) == 0
    assert level.group_idx[0, 0].tolist() == [0, 6, 22, 0, 0, 0, 0, 0]
    # Every other centre is alone in its ball.
    for s in range(1, 4):
        assert level.group_idx[0, s].tolist() == [int(level.fps_idx[0, s])] * 8


def test_padding_values_are_never_read():
    xyz0, lengths = clouds(4)
    xyz1, _ = clouds(4, pad=123.0)
    m = model(4)
    p0, p1 = m.plan(xyz0, lengths), m.plan(xyz1, lengths)
    for a, b in zip(p0, p1, strict=True):
        assert all(torch.equal(s, t) for s, t in zip(a, b, strict=True))
    out = [m(x, lengths, p, torch.Generator().manual_seed(9)) for x, p in ((xyz0, p0), (xyz1, p1))]
    assert torch.equal(out[0], out[1])


def test_no_host_read_and_the_spans():
    xyz, lengths = clouds(5)
    m = model(5)
    tracing.clear()
    try:
        with tracing.recording():
            plan = m.plan(xyz, lengths)
            m(xyz, lengths, plan, torch.Generator().manual_seed(1)).sum().backward()
        assert tracing.counts("sync.") == {}
        records = tracing.records()
    finally:
        tracing.clear()
    names = [r.name for r in records]
    for name in ("pointnet2.group", "pointnet2.mlp", "pointnet2.pool"):
        assert names.count(name) == 3, name
    assert names.count("pointnet2.head") == 1 and names.count("Gather.bwd") == 1
    (root,) = [r for r in records if r.name == "pointnet2.plan"]
    inside = [r.name for r in records if r.parent == root.id]
    assert inside == ["sample_farthest_points", "ball_query"] * 2


def test_eval_mode_draws_no_mask():
    xyz, lengths = clouds(6)
    m = model(6).eval()
    g = torch.Generator().manual_seed(2)
    state = g.get_state()
    with torch.no_grad():
        out = m(xyz, lengths, generator=g)
    assert torch.equal(g.get_state(), state)
    assert out.shape == (len(LENGTHS), 40) and bool(torch.isfinite(out).all())


def test_fill_empty_slots():
    idx = torch.tensor([[[3, -1, -1], [-1, -1, -1], [2, 5, 7]]])
    assert pointnet2.fill_empty_slots(idx).tolist() == [[[3, 3, 3], [-1, -1, -1], [2, 5, 7]]]
