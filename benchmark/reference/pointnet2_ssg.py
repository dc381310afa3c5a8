"""Plain reference of PointNet++ SSG classification training (Qi, Yi, Su,
Guibas, NeurIPS 2017, arXiv:1706.02413; the network of
``models/pointnet2_cls_ssg.py`` and the grouping of
``tf_ops/grouping/tf_grouping_g.cu`` ``query_ball_point`` in
github.com/charlesq34/pointnet2).

Plain ``torch`` in float32, with TF32 off; it imports nothing else. Every
distance is summed axis by axis, ``(dx*dx + dy*dy) + dz*dz``, each product
and sum rounded on its own.

- ``plan``: farthest point sampling by a loop over rounds (start at index 0;
  each round the point farthest from those taken, the first of equal
  maxima), then the ball query: the first ``nsample`` points in scan order
  whose squared distance is below r^2 (r * r in double, rounded to float32
  once), each empty slot set to slot 0's point.
- ``logits``: group, centre the xyz, put them before the features, run each
  shared MLP (``x @ W.T + b``; ``torch.nn.functional.batch_norm`` over the
  rows in training mode, by the batch's own statistics, updating the
  running statistics given; ReLU), the max over each group, and the head
  (FC, batch norm, ReLU, dropout mask; twice; FC).
- ``first_step``: the first training step from the benchmark's inputs
  alone: cross-entropy, gradients by autograd, Adam's first update, the
  batch norms' running statistics after it; with every pool entry's plan.
- ``exact_gradient``: that step's gradient in float64, which reads zero
  (to float64 rounding) where it is zero in exact arithmetic.

Weights are a dict under the names of the port's
``PointNet2ClsSSG.state_dict()``: ``sa{1,2,3}.linears.{i}.{weight,bias}``,
``sa{1,2,3}.norms.{i}.{weight,bias,running_mean,running_var}``,
``fc{1,2,3}.*``, ``bn{1,2}.*`` (``num_batches_tracked`` is not read).

Departures from the TF original:

- a point is in a ball when its squared distance is below r^2; the
  original compares the distance (a square root, floored at 1e-20) with r;
- batch norm with torch's momentum 0.1 for the running statistics (the
  original's decay rises from 0.5 to 0.99) and eps 1e-5 (the original
  1e-3); training normalises by the batch's own statistics and updates
  the running ones, which it does not read;
- the dropout masks are drawn from a torch generator (keep 0.5, kept values
  scaled by 2) and passed in (``draw_masks``);
- Adam as torch computes it (lr 1e-3, betas 0.9 / 0.999, eps 1e-8 added to
  the bias-corrected root); the original adds eps before the correction.

With ``tf32=True`` every matrix product, forward and both backward
products, takes its operands rounded to TF32 (10-bit mantissa, to nearest
even) and sums in float32, as a tensor core does: the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NPOINTS = (512, 128)
RADII = (0.2, 0.4)
NSAMPLES = (32, 64)
LEVELS = (("sa1", 3), ("sa2", 3), ("sa3", 3))  # (name, layers)
KEEP = 0.5
EPS = 1e-5
MOMENTUM = 0.1
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
STATS = ("running_mean", "running_var")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """x @ w.T with every product's operands rounded to TF32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return tf32_round(x) @ tf32_round(w).t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(w), g.t() @ tf32_round(x)


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance of matching (broadcast) rows, summed axis by axis."""
    t = a[..., 0] - b[..., 0]
    d = t * t
    for k in range(1, a.shape[-1]):
        t = a[..., k] - b[..., k]
        d = d + t * t
    return d


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points[n, idx[n, ...]], zero rows where idx is -1."""
    rows = torch.arange(points.shape[0], device=points.device)
    rows = rows.reshape(-1, *([1] * (idx.dim() - 1)))
    got = points[rows, idx.clamp(min=0)]
    return torch.where((idx >= 0)[..., None], got, 0.0)


def fps(xyz: torch.Tensor, lengths: list, K: int) -> torch.Tensor:
    """(N, K) indices of farthest point sampling, -1 past min(K, length)."""
    N, P, _ = xyz.shape
    dev = xyz.device
    lens = torch.tensor(lengths, device=dev)
    closest = torch.where(torch.arange(P, device=dev)[None] < lens[:, None],
                          torch.inf, -torch.inf)
    rows = torch.arange(N, device=dev)
    sel = torch.zeros(N, dtype=torch.int64, device=dev)
    taken = [sel]
    for _ in range(1, K):
        closest = torch.minimum(closest, sq_dist(xyz, xyz[rows, sel][:, None, :]))
        sel = closest.argmax(dim=1)
        taken.append(sel)
    idx = torch.stack(taken, 1)
    return torch.where(torch.arange(K, device=dev)[None] < lens.clamp(max=K)[:, None], idx, -1)


def ball_query(centres: torch.Tensor, held: list, xyz: torch.Tensor, lengths: list,
               K: int, radius: float) -> torch.Tensor:
    """(N, S, K) indices of the first K points of each cloud in scan order
    within ``radius`` of its first ``held`` centres, empty slots set to slot
    0 (a centre with no point in its ball keeps -1)."""
    r2 = torch.tensor(radius * radius, dtype=torch.float64).to(torch.float32)
    N, S, _ = centres.shape
    P = xyz.shape[1]
    dev = xyz.device
    col = torch.arange(P, device=dev)
    out = []
    for n in range(N):
        inside = sq_dist(centres[n][:, None, :], xyz[n][None, :, :]) < r2
        inside &= (col[None] < lengths[n]) & (torch.arange(S, device=dev)[:, None] < held[n])
        first = torch.where(inside, col[None], P).sort(dim=1).values[:, :K]
        if first.shape[1] < K:
            first = F.pad(first, (0, K - first.shape[1]), value=P)
        out.append(torch.where(first < P, first, -1))
    idx = torch.stack(out)
    return torch.where(idx < 0, idx[..., :1], idx)


def plan(xyz: torch.Tensor, lengths: list) -> list:
    """[(fps_idx, centres, group_idx)] of SA1 and SA2, as the port's
    ``PointNet2ClsSSG.plan`` returns them."""
    levels = []
    for npoint, radius, nsample in zip(NPOINTS, RADII, NSAMPLES):
        idx = fps(xyz, lengths, npoint)
        centres = _gather(xyz, idx)
        held = [min(n, npoint) for n in lengths]
        levels.append((idx, centres, ball_query(centres, held, xyz, lengths, nsample, radius)))
        xyz, lengths = centres, held
    return levels


def draw_masks(batch: int, generator: torch.Generator, device) -> list:
    """The head's two dropout masks, (batch, 512) then (batch, 256), drawn
    from ``generator`` in that order: Bernoulli(0.5) scaled by 2."""
    return [torch.empty((batch, width), device=device)
            .bernoulli_(KEEP, generator=generator).div_(KEEP) for width in (512, 256)]


def _linear(x, w, b, tf32):
    return (_TF32MatMul.apply(x, w) if tf32 else x @ w.t()) + b


def _layer(x, weights, stats, linear, norm, tf32):
    """Linear, batch norm by the batch's own statistics (the running ones
    in ``stats`` updated in place), ReLU."""
    x = _linear(x, weights[linear + ".weight"], weights[linear + ".bias"], tf32)
    x = F.batch_norm(x, stats[norm + ".running_mean"], stats[norm + ".running_var"],
                     weights[norm + ".weight"], weights[norm + ".bias"], training=True,
                     momentum=MOMENTUM, eps=EPS)
    return torch.relu(x)


def _set_abstraction(name, layers, x, weights, stats, tf32):
    """Shared MLP over (N, S, K, C) grouped points, then the max over K."""
    N, S, K, C = x.shape
    x = x.reshape(N * S * K, C)
    for i in range(layers):
        x = _layer(x, weights, stats, f"{name}.linears.{i}", f"{name}.norms.{i}", tf32)
    return x.reshape(N, S, K, -1).max(dim=2).values


def logits(weights: dict, stats: dict, xyz: torch.Tensor, levels: list, masks,
           tf32: bool = False):
    """(N, classes) logits of clouds ``xyz`` with plan ``levels``, in
    ``xyz``'s precision; ``stats`` holds the running statistics to update;
    ``masks`` are the head's dropout masks (None: no dropout)."""
    (_, c1, g1), (_, c2, g2) = levels
    c1, c2 = c1.to(xyz.dtype), c2.to(xyz.dtype)
    (n1, l1), (n2, l2), (n3, l3) = LEVELS
    f1 = _set_abstraction(n1, l1, _gather(xyz, g1) - c1[:, :, None, :], weights, stats, tf32)
    grouped = torch.cat([_gather(c1, g2) - c2[:, :, None, :], _gather(f1, g2)], -1)
    f2 = _set_abstraction(n2, l2, grouped, weights, stats, tf32)
    x = _set_abstraction(n3, l3, torch.cat([c2, f2], -1)[:, None], weights, stats, tf32)[:, 0]
    for k, mask in enumerate(masks or (None, None), start=1):
        x = _layer(x, weights, stats, f"fc{k}", f"bn{k}", tf32)
        if mask is not None:
            x = x * mask.to(x.dtype)
    return _linear(x, weights["fc3.weight"], weights["fc3.bias"], tf32)


def is_parameter(name: str) -> bool:
    return not name.endswith((*STATS, "num_batches_tracked"))


def _step(inputs: dict, dtype, tf32: bool):
    """Step 0 in ``dtype``: the plan (from the float32 clouds), the logits,
    the loss, the parameters' gradients and the running statistics after."""
    c = inputs["clouds"][0]
    weights = {k: v.detach().to(dtype).requires_grad_(True)
               for k, v in inputs["weights"].items() if is_parameter(k)}
    stats = {k: v.detach().to(dtype).clone() for k, v in inputs["weights"].items()
             if k.endswith(STATS)}
    gen = torch.Generator(device=c["xyz"].device)
    gen.manual_seed(inputs["dropout_seed"])
    masks = draw_masks(c["xyz"].shape[0], gen, c["xyz"].device)
    levels = plan(c["xyz"], c["lengths_host"])
    lg = logits(weights, stats, c["xyz"].to(dtype), levels, masks, tf32)
    loss = F.cross_entropy(lg, c["labels"])
    grads = dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))
    return lg.detach(), loss.item(), grads, stats


def first_step(inputs: dict, tf32: bool = False) -> dict:
    """The first training step from the benchmark's inputs alone: it takes
    ``inputs["clouds"][0]`` (``xyz``, host ``lengths_host``, ``labels``), the
    dropout masks from a generator on the clouds' device seeded with
    ``inputs["dropout_seed"]``, cross-entropy, autograd and Adam at
    ``inputs["lr"]`` from ``inputs["weights"]``.

    Returns ``plans`` (each pool entry's fps and group indices of both
    levels, a flat list an entry), ``logits``, ``loss``, ``grads`` (by
    parameter name) and ``change``: by state name, in float64, the
    parameters' change by Adam's first update and the running statistics'
    change by the step."""
    lg, loss, grads, stats = _step(inputs, torch.float32, tf32)
    lr, (b1, b2) = inputs["lr"], BETAS
    change = {}
    with torch.no_grad():
        for n, g in grads.items():
            m, v = (1 - b1) * g, (1 - b2) * g * g
            update = (lr / (1 - b1)) * (m / (torch.sqrt(v) / (1 - b2) ** 0.5 + ADAM_EPS))
            change[n] = -update.double()
        for n, t in stats.items():
            change[n] = t.double() - inputs["weights"][n].double()
    plans = [[t for idx, _, g in plan(c["xyz"], c["lengths_host"]) for t in (idx, g)]
             for c in inputs["clouds"]]
    return {"plans": plans, "logits": lg, "loss": loss, "grads": grads, "change": change}


def exact_gradient(inputs: dict) -> dict:
    """``first_step``'s gradient computed in float64 (the same plan and
    masks), by parameter name: where the gradient is zero in exact
    arithmetic (a bias ahead of a batch norm, a batch norm's shift whose
    every output the next batch norm takes away) it reads about 1e-16 of
    the rest, where float32 leaves rounding up to a tenth of it."""
    return _step(inputs, torch.float64, False)[2]
