"""Plain reference of Point Transformer semantic segmentation training
(Zhao, Jiang, Jia, Torr, Koltun, ICCV 2021, arXiv:2012.09164; the network of
``model/pointtransformer/pointtransformer_seg.py``, ``pointtransformer_seg_repro``,
in github.com/hszhao/point-transformer, trained as its S3DIS configuration:
cross-entropy and SGD with momentum and weight decay).

Plain ``torch``, with TF32 off, and the benchmark's shared arithmetic
(``benchmark/plain.py``); it imports nothing of the port. Features are
packed (the rows of every cloud one after another, as the source keeps
them); each cloud's points are handled as a slice of its own.

- ``plan``: each level's points, its neighbours and the sampling between
  levels, from the coordinates alone. Farthest point sampling by a loop over
  rounds (start at each cloud's first point; each round the point farthest
  from those taken, the first of equal maxima), L // stride points of a
  cloud of L. KNN in blocks of query rows on an int64 key (the squared
  distance's float32 bits, then the index; the distance summed axis by
  axis, ``(dx*dx + dy*dy) + dz*dz``), so the nearest come first and equal
  distances go to the lowest index: each point's nsample nearest of its own
  level (itself included), of the level above for a ``TransitionDown``,
  and its 3 nearest of the next coarser level with their distances.
- ``logits``: the network (``Arch``), every ``Linear`` ``x @ W.T (+ b)``,
  every batch norm ``torch.nn.functional.batch_norm`` in training mode over
  all rows of its input (every (point, neighbour) pair of a grouped tensor),
  updating the running statistics given:

  ``PointTransformerLayer``: q, k, v = Linear(x); p_r = Linear(3, C)(ReLU(BN(
  Linear(3, 3)(p_j - p_i)))); w = (k_j - q_i) + p_r; w = Linear(C/8, C/8)(
  ReLU(BN(Linear(C, C/8)(ReLU(BN(w)))))); softmax over the neighbours;
  y_i[c] = sum_j (v_j + p_r)[c] * w[c mod C/8].
  ``PointTransformerBlock``: ReLU(BN(Linear(x))), ReLU(BN(layer)),
  BN(Linear), ReLU(. + x). ``TransitionDown``: ReLU(BN(Linear(x))) at
  stride 1; else [p_j - p_i, x_j] over the nsample nearest of the level
  above, Linear, BN, ReLU, max. ``TransitionUp``: at the coarsest level
  ReLU(BN(Linear([x, ReLU(Linear(cloud mean))]))); else ReLU(BN(Linear(x)))
  + sum_j w_j ReLU(BN(Linear(x_coarse)))_j over the 3 nearest coarser
  points, w_j = 1 / (sqrt(d2_j) + 1e-8) normalised to sum 1. Head:
  Linear(ReLU(BN(Linear(x)))).
- ``first_step``: the first training step from the benchmark's inputs
  alone: every pool entry's plan, the first entry's logits, cross-entropy
  over every valid point, the gradients by autograd, SGD's first update
  (momentum 0.9 and weight decay 1e-4: the change -lr (g + wd p)) and the
  batch norms' running statistics after it.
- ``exact_gradient``: that step's gradient in float64 (the same plan),
  which reads zero (to float64 rounding) where it is zero in exact
  arithmetic.

Weights are a dict under the names of the port's
``PointTransformerSeg.state_dict()``, which are the source's
(``enc1.0.linear.weight``, ``enc1.1.transformer2.linear_w.2.weight``,
``dec5.0.linear1.0.weight``, ``cls.3.bias``, ...; ``num_batches_tracked``
is not read).

Departures from the source:

- ties: FPS keeps the first of equal maxima and the KNN the lowest index on
  equal distances; the source's CUDA kernels leave both to their reductions;
- the KNN is taken once a level, for every layer of it, where the source
  queries the same neighbours again in each layer;
- coordinates come padded with lengths (the port's ops take them so) and
  are packed here cloud by cloud; padding is never read;
- a cloud with fewer points than a level's nsample raises ``ValueError``
  (the source's KNN would repeat points);
- batch norm at torch's defaults (momentum 0.1, eps 1e-5), as the source's
  ``nn.BatchNorm1d``.

With ``tf32=True`` every matrix product, forward and both backward
products, takes its operands rounded to TF32 (10-bit mantissa, to nearest
even) and sums in float32, as a tensor core does: the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.plain import key_of, sq_dist, tf32_round


class Arch(NamedTuple):
    in_channels: int = 6
    classes: int = 13
    planes: tuple = (32, 64, 128, 256, 512)
    strides: tuple = (1, 4, 4, 4, 4)
    nsample: tuple = (8, 16, 16, 16, 16)
    blocks: tuple = (1, 2, 3, 5, 2)
    share_planes: int = 8


PUBLISHED = Arch()
UP_K = 3
EPS = 1e-5
MOMENTUM = 0.1
BLOCK = 2048  # query rows of a KNN block
STATS = ("running_mean", "running_var")


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


def fps(xyz: torch.Tensor, lengths: list, K: list) -> torch.Tensor:
    """(N, max K) indices of farthest point sampling of padded clouds, the
    first K[n] of cloud n, -1 after them."""
    N, P, _ = xyz.shape
    dev = xyz.device
    lens = torch.tensor(lengths, device=dev)
    closest = torch.where(torch.arange(P, device=dev)[None] < lens[:, None],
                          torch.inf, -torch.inf)
    rows = torch.arange(N, device=dev)
    sel = torch.zeros(N, dtype=torch.int64, device=dev)
    taken = [sel]
    for _ in range(1, max(K)):
        closest = torch.minimum(closest, sq_dist(xyz, xyz[rows, sel][:, None, :]))
        sel = closest.argmax(dim=1)
        taken.append(sel)
    idx = torch.stack(taken, 1)
    keep = torch.arange(max(K), device=dev)[None] < torch.tensor(K, device=dev)[:, None]
    return torch.where(keep, idx, -1)


def knn(q: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, k) indices of the k nearest rows of p (P, 3) to each row of q
    (Q, 3), nearest first, ties to the lowest index."""
    if p.shape[0] < k:
        raise ValueError(f"a KNN of {k} needs at least {k} points (got {p.shape[0]})")
    ip = torch.arange(p.shape[0], device=q.device, dtype=torch.int64)
    out = []
    for s in range(0, q.shape[0], BLOCK):
        key = key_of(sq_dist(q[s:s + BLOCK, None, :], p[None, :, :]), ip[None, :])
        out.append(torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF)
    return torch.cat(out)


def level_lengths(lengths: list, arch: Arch = PUBLISHED) -> list:
    out = [list(lengths)]
    for s in arch.strides[1:]:
        out.append([n // s for n in out[-1]])
    for i, (lens, k) in enumerate(zip(out, arch.nsample)):
        need = k if i == 0 else max(k, UP_K)
        if min(lens) < need:
            raise ValueError(f"level {i + 1} needs clouds of at least {need} points (got {lens})")
    return out


def plan(xyz: torch.Tensor, lengths: list, arch: Arch = PUBLISHED) -> list:
    """Per level, a dict: ``lengths`` (host ints), ``pos`` (T, 3) packed
    coordinates, ``fps`` (N, max L) indices into each cloud of the level
    above (-1 after L; None at level 1), ``down``, ``nbr`` and ``up`` (T, K)
    packed rows of the level above, of this level and of the next coarser
    level (None where there is none), ``up_d2`` (T, 3) the squared
    distances of ``up``."""
    levels = []
    for i, lens in enumerate(level_lengths(lengths, arch)):
        first = [sum(lens[:n]) for n in range(len(lens))]
        if i == 0:
            clouds = [xyz[n, :L] for n, L in enumerate(lens)]
            idx = None
        else:
            above = levels[-1]
            padded = torch.zeros((len(lens), max(above["lengths"]), 3), device=xyz.device)
            for n, c in enumerate(above["clouds"]):
                padded[n, :c.shape[0]] = c
            idx = fps(padded, above["lengths"], lens)
            clouds = [c[idx[n, :L]] for n, (c, L) in enumerate(zip(above["clouds"], lens))]
        level = {"lengths": lens, "first": first, "clouds": clouds, "pos": torch.cat(clouds),
                 "fps": idx, "down": None, "up": None, "up_d2": None}
        k = arch.nsample[i]
        level["nbr"] = torch.cat([knn(c, c, k) + f for c, f in zip(clouds, first)])
        if i:
            level["down"] = torch.cat([knn(c, a, k) + f for c, a, f
                                       in zip(clouds, above["clouds"], above["first"])])
        levels.append(level)
    for fine, coarse in zip(levels, levels[1:]):
        up = [knn(c, a, UP_K) for c, a in zip(fine["clouds"], coarse["clouds"])]
        fine["up_d2"] = torch.cat([sq_dist(c[:, None, :], a[i]) for c, a, i
                                   in zip(fine["clouds"], coarse["clouds"], up)])
        fine["up"] = torch.cat([i + f for i, f in zip(up, coarse["first"])])
    return levels


def plan_indices(levels: list) -> list:
    """The plan's indices in the order the benchmark compares them: per
    level its FPS, down, self and up indices, where it has them."""
    return [level[k] for level in levels for k in ("fps", "down", "nbr", "up")
            if level[k] is not None]


class _Net:
    """The network's arithmetic on a weight dict, in the weights' dtype."""

    def __init__(self, weights: dict, stats: dict, arch: Arch, tf32: bool):
        self.w, self.stats, self.arch, self.tf32 = weights, stats, arch, tf32

    def linear(self, x, name, bias=True):
        w = self.w[name + ".weight"]
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        y = _TF32MatMul.apply(x, w) if self.tf32 else x @ w.t()
        if bias:
            y = y + self.w[name + ".bias"]
        return y.reshape(*shape[:-1], w.shape[0])

    def bn(self, x, name):
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), self.stats[name + ".running_mean"],
                         self.stats[name + ".running_var"], self.w[name + ".weight"],
                         self.w[name + ".bias"], training=True, momentum=MOMENTUM, eps=EPS)
        return y.reshape(shape)

    def attention(self, name, x, level):
        T, C = x.shape
        s = self.arch.share_planes
        nbr, pos = level["nbr"], level["pos"].to(x.dtype)
        K = nbr.shape[1]
        q = self.linear(x, name + ".linear_q")
        k = self.linear(x, name + ".linear_k")[nbr]
        v = self.linear(x, name + ".linear_v")[nbr]
        p = torch.relu(self.bn(self.linear(pos[nbr] - pos[:, None], name + ".linear_p.0"),
                               name + ".linear_p.1"))
        p = self.linear(p, name + ".linear_p.3")
        w = (k - q[:, None]) + p
        w = torch.relu(self.bn(w, name + ".linear_w.0"))
        w = torch.relu(self.bn(self.linear(w, name + ".linear_w.2"), name + ".linear_w.3"))
        w = torch.softmax(self.linear(w, name + ".linear_w.5"), dim=1)
        return ((v + p).view(T, K, s, C // s) * w.unsqueeze(2)).sum(1).view(T, C)

    def block(self, name, x, level):
        y = torch.relu(self.bn(self.linear(x, name + ".linear1", False), name + ".bn1"))
        y = torch.relu(self.bn(self.attention(name + ".transformer2", y, level), name + ".bn2"))
        return torch.relu(self.bn(self.linear(y, name + ".linear3", False), name + ".bn3") + x)

    def down(self, name, x, level, above):
        if level["down"] is None:
            return torch.relu(self.bn(self.linear(x, name + ".linear", False), name + ".bn"))
        pos, pos_above = level["pos"].to(x.dtype), above["pos"].to(x.dtype)
        g = torch.cat([pos_above[level["down"]] - pos[:, None], x[level["down"]]], -1)
        y = torch.relu(self.bn(self.linear(g, name + ".linear", False), name + ".bn"))
        return y.max(dim=1).values

    def up_head(self, name, x, level):
        parts = []
        for xb in x.split(level["lengths"]):
            g = torch.relu(self.linear(xb.sum(0, True) / xb.shape[0], name + ".linear2.0"))
            parts.append(torch.cat([xb, g.repeat(xb.shape[0], 1)], 1))
        return torch.relu(self.bn(self.linear(torch.cat(parts), name + ".linear1.0"),
                                  name + ".linear1.1"))

    def up(self, name, x, coarse, level):
        y = torch.relu(self.bn(self.linear(x, name + ".linear1.0"), name + ".linear1.1"))
        c = torch.relu(self.bn(self.linear(coarse, name + ".linear2.0"), name + ".linear2.1"))
        recip = 1.0 / (torch.sqrt(level["up_d2"].to(x.dtype)) + 1e-8)
        weight = recip / recip.sum(1, keepdim=True)
        interp = torch.zeros_like(y)
        for j in range(UP_K):
            interp = interp + c[level["up"][:, j]] * weight[:, j:j + 1]
        return y + interp

    def logits(self, feats: torch.Tensor, levels: list) -> torch.Tensor:
        x, skips, n = feats, [], len(levels)
        for i, level in enumerate(levels):
            x = self.down(f"enc{i + 1}.0", x, level, levels[i - 1] if i else None)
            for b in range(self.arch.blocks[i]):
                x = self.block(f"enc{i + 1}.{b + 1}", x, level)
            skips.append(x)
        for i in reversed(range(n)):
            if i == n - 1:
                x = self.up_head(f"dec{i + 1}.0", skips[i], levels[i])
            else:
                x = self.up(f"dec{i + 1}.0", skips[i], x, levels[i])
            x = self.block(f"dec{i + 1}.1", x, levels[i])
        x = torch.relu(self.bn(self.linear(x, "cls.0"), "cls.1"))
        return self.linear(x, "cls.3")


def packed_input(xyz: torch.Tensor, feats: torch.Tensor, lengths: list) -> torch.Tensor:
    """(T, 3 + C) the network's input: each valid point's xyz, then its
    features, cloud after cloud."""
    return torch.cat([torch.cat([xyz[n, :L], feats[n, :L]], -1) for n, L in enumerate(lengths)])


def is_parameter(name: str) -> bool:
    return not name.endswith((*STATS, "num_batches_tracked"))


def forward(weights: dict, xyz, feats, lengths, levels, dtype=torch.float32,
            tf32: bool = False, arch: Arch = PUBLISHED):
    """The network's logits in ``dtype`` from the given weights and plan:
    (logits, the parameters as leaves that require their gradient, the
    running statistics after)."""
    params = {k: v.detach().to(dtype).requires_grad_(torch.is_grad_enabled())
              for k, v in weights.items() if is_parameter(k)}
    stats = {k: v.detach().to(dtype).clone() for k, v in weights.items() if k.endswith(STATS)}
    net = _Net(params, stats, arch, tf32)
    return net.logits(packed_input(xyz, feats, lengths).to(dtype), levels), params, stats


def step(weights: dict, xyz, feats, lengths, labels, levels=None, dtype=torch.float32,
         tf32: bool = False, arch: Arch = PUBLISHED):
    """One forward and backward in ``dtype`` from the given weights:
    (logits, loss, gradients by parameter name, running statistics after,
    the plan)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if levels is None:
            levels = plan(xyz, lengths, arch)
        lg, params, stats = forward(weights, xyz, feats, lengths, levels, dtype, tf32, arch)
        loss = F.cross_entropy(lg, labels)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        return lg.detach(), loss.item(), grads, stats, levels
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def first_step(inputs: dict, tf32: bool = False) -> dict:
    """The first training step from the benchmark's inputs alone: it takes
    the network ``Arch(**inputs["arch"])``, ``inputs["clouds"][0]``
    (``xyz``, ``feats``, host ``lengths_host``, packed ``labels``),
    cross-entropy, autograd and SGD at ``inputs["lr"]``,
    ``["weight_decay"]`` from ``inputs["weights"]``.

    Returns ``plans`` (each pool entry's ``plan_indices``), ``logits``,
    ``loss``, ``grads`` (by parameter name) and ``change``: by state name,
    in float64, the parameters' change by SGD's first update (in float32,
    as the update is made) and the running statistics' change by the
    step."""
    c, arch = inputs["clouds"][0], Arch(**inputs["arch"])
    lg, loss, grads, stats, levels = step(inputs["weights"], c["xyz"], c["feats"],
                                          c["lengths_host"], c["labels"], tf32=tf32, arch=arch)
    lr, wd = inputs["lr"], inputs["weight_decay"]
    change = {}
    with torch.no_grad():
        for n, g in grads.items():
            p = inputs["weights"][n]
            change[n] = (p - lr * (g + wd * p)).double() - p.double()
        for n, t in stats.items():
            change[n] = t.double() - inputs["weights"][n].double()
    plans = [plan_indices(levels)]
    plans += [plan_indices(plan(e["xyz"], e["lengths_host"], arch))
              for e in inputs["clouds"][1:]]
    return {"plans": plans, "logits": lg, "loss": loss, "grads": grads, "change": change,
            "levels": levels}


def exact_gradient(inputs: dict, levels=None) -> dict:
    """``first_step``'s gradient computed in float64 from the same plan
    (``levels``, computed when None), by parameter name."""
    c = inputs["clouds"][0]
    return step(inputs["weights"], c["xyz"], c["feats"], c["lengths_host"], c["labels"],
                levels, torch.float64, arch=Arch(**inputs["arch"]))[2]
