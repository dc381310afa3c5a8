"""Plain reference of Point Transformer V2 semantic segmentation training
(Wu, Lao, Jiang, Liu, Zhao, NeurIPS 2022, arXiv:2210.05666; the ``PT-v2m2``
network of ``pointcept/models/point_transformer_v2/point_transformer_v2m2_base.py``
in github.com/Pointcept/Pointcept, trained as its ScanNet configuration
``configs/scannet/semseg-pt-v2m2-0-base.py``: cross-entropy and AdamW).

Plain ``torch``, with TF32 off, and the benchmark's shared arithmetic
(``benchmark/plain.py``, and the blocked KNN and TF32 product of the Point
Transformer's reference); it imports nothing of the port. Features are
packed (the rows of every cloud one after another, as the source keeps
them).

- ``plan``: each level's points and neighbours, and the pooling between
  levels, from the coordinates alone. Grid pooling: each cloud's least
  coordinate on each axis as its start; a point's voxel on each axis the
  float32 ``(p - start) / g`` truncated; clusters numbered by cloud, then z,
  y, x (grid_cluster's key over the batch's voxel counts, stably sorted);
  each cluster's position its rows' coordinates added one by one in sorted
  order from 0, over its count. KNN in blocks of query rows, the nearest
  first and equal distances to the lowest index (the Point Transformer
  reference's ``knn``): at level 0 the patch embedding's 8 and the
  decoder's 16, each computed on its own; the 16 of the encoder's and
  decoder's blocks at levels 1-4.
- ``logits``: the network (``Arch``), every ``Linear`` ``x @ W.T (+ b)``,
  every batch norm ``torch.nn.functional.batch_norm`` in training mode over
  all rows of its input (every (point, neighbour) pair of a grouped tensor),
  updating the running statistics given:

  ``GroupedVectorAttention(C, G)``: q = ReLU(BN(Linear(x))), k =
  ReLU(BN(Linear(x))), v = Linear(x); peb = Linear(C, C)(ReLU(BN(Linear(3,
  C)(p_j - p_i)))); r = k_j - q_i (times the same form's pem where
  ``pe_multiplier``) + peb; w = Linear(G, G)(ReLU(BN(Linear(C, G)(r))));
  softmax over the neighbours; y_i[g C/G + t] = sum_j (v_j + peb)[g C/G + t]
  w_j[g]. ``Block``: ReLU(BN(Linear(x))), ReLU(BN(attention)), BN(Linear),
  ReLU(x + DropPath(.)), DropPath multiplying each row by the caller's
  mask. ``GridPool``: ReLU(BN(Linear(x))), then each cluster's channel-wise
  maximum, the first of equal maxima in sorted order taking the gradient.
  ``UnpoolWithSkip``: ReLU(BN(Linear(x_coarse)))[cluster] +
  ReLU(BN(Linear(x_skip))). Head: Linear(ReLU(BN(Linear(x)))).
- ``first_step``: the first training step from the benchmark's inputs
  alone: every pool entry's plan, the first entry's logits, cross-entropy
  over every valid point, the gradients by autograd, AdamW's first update
  (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay: p (1 - lr wd) - lr
  m / (sqrt(v) + eps) with the bias corrections) and the batch norms'
  running statistics after it.
- ``exact_gradient``: that step's gradient in float64 (the same plan and
  masks), which reads zero (to float64 rounding) where it is zero in exact
  arithmetic.

Weights are a dict under the names of the port's
``PointTransformerV2Seg.state_dict()``, which are the source's
(``patch_embed.proj.0.weight``, ``enc_stages.0.down.fc.weight``,
``enc_stages.2.blocks.blocks.3.attn.weight_encoding.1.norm.running_var``,
``dec_stages.0.up.proj_skip.0.bias``, ``seg_head.3.bias``, ...;
``num_batches_tracked`` is not read).

Departures from the source: the pooled means' order of summation and the
maximum's ties (torch_scatter's ``segment_csr`` leaves both to its
reduction); KNN ties to the lowest index; the KNN taken once a level and K
for every block of it, where the source queries it again in each block
sequence; a cloud with fewer points at a level than its K raises
``ValueError`` (the source pads with -1 and masks the weights); batch norm
at torch's defaults (momentum 0.1, eps 1e-5), as the source's
``nn.BatchNorm1d``.

With ``tf32=True`` every matrix product, forward and both backward
products, takes its operands rounded to TF32 and sums in float32, as a
tensor core does: the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.point_transformer_seg import EPS, MOMENTUM, STATS, _TF32MatMul, knn


class Arch(NamedTuple):
    in_channels: int = 9
    classes: int = 20
    patch_embed_depth: int = 1
    patch_embed_channels: int = 48
    patch_embed_groups: int = 6
    patch_embed_neighbours: int = 8
    enc_depths: tuple = (2, 2, 6, 2)
    enc_channels: tuple = (96, 192, 384, 512)
    enc_groups: tuple = (12, 24, 48, 64)
    enc_neighbours: tuple = (16, 16, 16, 16)
    dec_depths: tuple = (1, 1, 1, 1)
    dec_channels: tuple = (48, 96, 192, 384)
    dec_groups: tuple = (6, 12, 24, 48)
    dec_neighbours: tuple = (16, 16, 16, 16)
    grid_sizes: tuple = (0.06, 0.12, 0.24, 0.48)
    drop_path_rate: float = 0.3
    pe_multiplier: bool = False


PUBLISHED = Arch()
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def level_neighbours(arch: Arch) -> list:
    """The K each level's blocks use, ascending: level 0 the patch
    embedding's and decoder stage 0's, level i + 1 encoder stage i's and
    decoder stage i + 1's."""
    n = len(arch.enc_depths)
    out = [{arch.patch_embed_neighbours, arch.dec_neighbours[0]}]
    out += [{arch.enc_neighbours[i]} | ({arch.dec_neighbours[i + 1]} if i + 1 < n else set())
            for i in range(n)]
    return [sorted(ks) for ks in out]


def blocks(arch: Arch) -> list:
    """Every block: (name, level, width, groups, K), in the order the
    network runs them."""
    out = [(f"patch_embed.blocks.blocks.{b}", 0, arch.patch_embed_channels,
            arch.patch_embed_groups, arch.patch_embed_neighbours)
           for b in range(arch.patch_embed_depth)]
    for i, depth in enumerate(arch.enc_depths):
        out += [(f"enc_stages.{i}.blocks.blocks.{b}", i + 1, arch.enc_channels[i],
                 arch.enc_groups[i], arch.enc_neighbours[i]) for b in range(depth)]
    for i in reversed(range(len(arch.dec_depths))):
        out += [(f"dec_stages.{i}.blocks.blocks.{b}", i, arch.dec_channels[i],
                 arch.dec_groups[i], arch.dec_neighbours[i]) for b in range(arch.dec_depths[i])]
    return out


def drop_path_rates(arch: Arch) -> dict:
    """Each block's drop path rate where above 0, by name: the source's
    ``torch.linspace(0, rate, blocks)`` over the encoder's blocks and again
    over the decoder's, stage 0 first; the patch embedding's take 0."""
    out = {}
    for kind, depths in (("enc_stages", arch.enc_depths), ("dec_stages", arch.dec_depths)):
        names = [f"{kind}.{i}.blocks.blocks.{b}" for i, d in enumerate(depths)
                 for b in range(d)]
        line = torch.linspace(0, arch.drop_path_rate, len(names)).tolist()
        out.update({n: r for n, r in zip(names, line) if r > 0})
    return out


def _fold(values, order, offsets, step, init):
    """Each segment's fold over its rows in sorted order: ``acc =
    step(acc, value, row)`` where the segment reaches position j, from
    ``init(values, rows)`` at j = 0."""
    starts, counts = offsets[:-1], offsets.diff()
    rows = order[starts]
    acc = init(values[rows], rows)
    for j in range(1, int(counts.max())):
        at = (starts + j).clamp(max=order.numel() - 1)
        rows = order[at]
        new = step(acc, values[rows], rows)
        live = (j < counts)[:, None]
        acc = tuple(torch.where(live, n, a) for n, a in zip(new, acc))
    return acc


def grid_pool(pos: torch.Tensor, lengths: list, grid: float) -> dict:
    """The pooling of packed points ``pos`` (T, 3) of clouds ``lengths``:
    ``cluster`` (T,), ``order`` (T,), ``offsets`` (M + 1,), ``lengths``
    (each cloud's clusters) and ``pos`` (M, 3), the clusters' means."""
    dev = pos.device
    cloud = torch.repeat_interleave(torch.arange(len(lengths), device=dev),
                                    torch.tensor(lengths, device=dev))
    first = [sum(lengths[:n]) for n in range(len(lengths) + 1)]
    start = torch.stack([pos[a:b].amin(0) if b > a else pos.new_zeros(3)
                         for a, b in zip(first, first[1:])])
    cell = torch.full((1,), grid, dtype=torch.float32, device=dev)
    voxel = ((pos - start[cloud]) / cell).to(torch.int64)
    n = voxel.amax(0) + 1
    key = ((cloud * n[2] + voxel[:, 2]) * n[1] + voxel[:, 1]) * n[0] + voxel[:, 0]
    order = torch.argsort(key, stable=True)
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[order][1:] != key[order][:-1]
    ids = torch.cumsum(head, 0) - 1
    cluster = torch.empty_like(ids)
    cluster[order] = ids
    offsets = torch.cat([torch.nonzero(head)[:, 0], torch.tensor([pos.shape[0]], device=dev)])
    counts = torch.bincount(cloud[order][head], minlength=len(lengths)).tolist()
    (total,) = _fold(pos, order, offsets, lambda a, v, r: (a[0] + v,),
                     lambda v, r: (torch.zeros_like(v) + v,))
    means = total / offsets.diff()[:, None].to(pos.dtype)
    return {"cluster": cluster, "order": order, "offsets": offsets, "lengths": counts,
            "pos": means}


def first_max_rows(x: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(M, C) the row holding each cluster's largest value of each channel
    of x (T, C), the first of equal maxima in sorted order."""
    C = x.shape[1]

    def better(acc, v, r):
        take = v > acc[0]
        return torch.where(take, v, acc[0]), torch.where(take, r[:, None].expand(-1, C), acc[1])

    with torch.no_grad():
        return _fold(x, order, offsets, better, lambda v, r: (v, r[:, None].expand(-1, C)))[1]


def plan(xyz: torch.Tensor, lengths: list, arch: Arch = PUBLISHED) -> list:
    """Per level, a dict: ``lengths`` (host ints), ``pos`` (T, 3) packed
    coordinates, ``nbr`` ({K: (T, K) packed rows of this level}) and
    ``pool`` (``grid_pool``'s dict into the next level, None at the
    last)."""
    pos = torch.cat([xyz[n, :L] for n, L in enumerate(lengths)]).to(torch.float32)
    levels, lens = [], list(lengths)
    for i, ks in enumerate(level_neighbours(arch)):
        first = [sum(lens[:n]) for n in range(len(lens))]
        clouds = pos.split(lens)
        nbr = {k: torch.cat([knn(c, c, k) + f for c, f in zip(clouds, first)]) for k in ks}
        pool = grid_pool(pos, lens, arch.grid_sizes[i]) if i < len(arch.grid_sizes) else None
        levels.append({"lengths": lens, "pos": pos, "nbr": nbr, "pool": pool})
        if pool is not None:
            pos, lens = pool["pos"], pool["lengths"]
    return levels


def plan_indices(levels: list) -> list:
    """The plan in the order the benchmark compares it: per level its
    pooling (each row's cluster, the sorted order, each cloud's clusters,
    the clusters' coordinates) where it has one, then its KNN by K."""
    out = []
    for level in levels:
        p = level["pool"]
        if p is not None:
            out += [p["cluster"], p["order"], torch.tensor(p["lengths"]), p["pos"]]
        out += [level["nbr"][k] for k in sorted(level["nbr"])]
    return out


class _Net:
    """The network's arithmetic on a weight dict, in the weights' dtype."""

    def __init__(self, weights: dict, stats: dict, arch: Arch, tf32: bool, masks: dict):
        self.w, self.stats, self.arch, self.tf32, self.masks = weights, stats, arch, tf32, masks

    def linear(self, x, name, bias=True):
        w = self.w[name + ".weight"]
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        y = _TF32MatMul.apply(x, w) if self.tf32 else x @ w.t()
        if bias:
            y = y + self.w[name + ".bias"]
        return y.reshape(*shape[:-1], w.shape[0])

    def bn(self, x, name):
        name += ".norm"
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), self.stats[name + ".running_mean"],
                         self.stats[name + ".running_var"], self.w[name + ".weight"],
                         self.w[name + ".bias"], training=True, momentum=MOMENTUM, eps=EPS)
        return y.reshape(shape)

    def mlp(self, x, name, bias=True, last=False):
        """ReLU(BN(Linear(x))) of the Sequential ``name``, then its Linear
        3 where ``last``."""
        y = torch.relu(self.bn(self.linear(x, name + ".0", bias), name + ".1"))
        return self.linear(y, name + ".3") if last else y

    def attention(self, name, x, idx, rel, groups):
        T, C = x.shape
        K = idx.shape[1]
        q = self.mlp(x, name + ".linear_q")
        k = self.mlp(x, name + ".linear_k")[idx]
        v = self.linear(x, name + ".linear_v")[idx]
        r = k - q[:, None]
        if self.arch.pe_multiplier:
            r = r * self.mlp(rel, name + ".linear_p_multiplier", last=True)
        peb = self.mlp(rel, name + ".linear_p_bias", last=True)
        w = self.mlp(r + peb, name + ".weight_encoding", last=True)
        w = torch.softmax(w, dim=1)
        return ((v + peb).view(T, K, groups, C // groups) * w.unsqueeze(-1)).sum(1).view(T, C)

    def block(self, name, x, level, groups, K):
        idx = level["nbr"][K]
        rel = (level["pos"][idx] - level["pos"][:, None]).to(x.dtype)
        y = torch.relu(self.bn(self.linear(x, name + ".fc1", False), name + ".norm1"))
        y = torch.relu(self.bn(self.attention(name + ".attn", y, idx, rel, groups),
                               name + ".norm2"))
        y = self.bn(self.linear(y, name + ".fc3", False), name + ".norm3")
        if name in self.masks:
            y = y * self.masks[name].to(x.dtype)[:, None]
        return torch.relu(x + y)

    def stage_blocks(self, x, level, specs):
        for name, _, _, groups, K in specs:
            x = self.block(name, x, level, groups, K)
        return x

    def logits(self, feats: torch.Tensor, levels: list) -> torch.Tensor:
        spec = blocks(self.arch)
        at = {}
        for s in spec:
            at.setdefault(s[0].rsplit(".blocks.", 1)[0], []).append(s)
        x = self.mlp(feats, "patch_embed.proj", bias=False)
        x = self.stage_blocks(x, levels[0], at["patch_embed.blocks"])
        skips = [x]
        for i in range(len(self.arch.enc_depths)):
            p = levels[i]["pool"]
            down = f"enc_stages.{i}.down"
            h = torch.relu(self.bn(self.linear(x, down + ".fc", False), down + ".norm"))
            x = h.gather(0, first_max_rows(h, p["order"], p["offsets"]))
            x = self.stage_blocks(x, levels[i + 1], at[f"enc_stages.{i}.blocks"])
            skips.append(x)
        for i in reversed(range(len(self.arch.dec_depths))):
            up = f"dec_stages.{i}.up"
            x = (self.mlp(x, up + ".proj")[levels[i]["pool"]["cluster"]]
                 + self.mlp(skips[i], up + ".proj_skip"))
            x = self.stage_blocks(x, levels[i], at[f"dec_stages.{i}.blocks"])
        return self.mlp(x, "seg_head", last=True)


def packed_input(xyz: torch.Tensor, feats: torch.Tensor, lengths: list) -> torch.Tensor:
    """(T, 3 + C) the network's input: each valid point's xyz, then its
    features, cloud after cloud."""
    return torch.cat([torch.cat([xyz[n, :L], feats[n, :L]], -1) for n, L in enumerate(lengths)])


def is_parameter(name: str) -> bool:
    return not name.endswith((*STATS, "num_batches_tracked"))


def forward(weights: dict, xyz, feats, lengths, levels, masks=None, dtype=torch.float32,
            tf32: bool = False, arch: Arch = PUBLISHED):
    """The network's logits in ``dtype`` from the given weights, plan and
    drop path masks (by block name; None or missing: no drop): (logits, the
    parameters as leaves that require their gradient, the running
    statistics after)."""
    params = {k: v.detach().to(dtype).requires_grad_(torch.is_grad_enabled())
              for k, v in weights.items() if is_parameter(k)}
    stats = {k: v.detach().to(dtype).clone() for k, v in weights.items() if k.endswith(STATS)}
    net = _Net(params, stats, arch, tf32, masks or {})
    return net.logits(packed_input(xyz, feats, lengths).to(dtype), levels), params, stats


def step(weights: dict, xyz, feats, lengths, labels, masks=None, levels=None,
         dtype=torch.float32, tf32: bool = False, arch: Arch = PUBLISHED):
    """One forward and backward in ``dtype`` from the given weights:
    (logits, loss, gradients by parameter name, running statistics after,
    the plan)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if levels is None:
            levels = plan(xyz, lengths, arch)
        lg, params, stats = forward(weights, xyz, feats, lengths, levels, masks, dtype, tf32,
                                    arch)
        loss = F.cross_entropy(lg, labels)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        return lg.detach(), loss.item(), grads, stats, levels
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def adamw_change(p: torch.Tensor, g: torch.Tensor, lr: float, wd: float) -> torch.Tensor:
    """AdamW's first update of p from gradient g, in p's float32, as a
    float64 change: p (1 - lr wd) - lr / (1 - b1) m / (sqrt(v) / sqrt(1 - b2)
    + eps), m = (1 - b1) g, v = (1 - b2) g^2."""
    b1, b2 = BETAS
    m, v = (1 - b1) * g, (1 - b2) * g * g
    new = p * (1 - lr * wd) - (lr / (1 - b1)) * (m / (torch.sqrt(v) / (1 - b2) ** 0.5
                                                      + ADAM_EPS))
    return new.double() - p.double()


def first_step(inputs: dict, tf32: bool = False) -> dict:
    """The first training step from the benchmark's inputs alone: it takes
    the network ``Arch(**inputs["arch"])``, ``inputs["clouds"][0]``
    (``xyz``, ``feats``, host ``lengths_host``, packed ``labels``,
    ``drop_masks``), cross-entropy, autograd and AdamW at ``inputs["lr"]``,
    ``["weight_decay"]`` from ``inputs["weights"]``.

    Returns ``plans`` (each pool entry's ``plan_indices``), ``logits``,
    ``loss``, ``grads`` (by parameter name), ``change`` (by state name, in
    float64: the parameters' change by AdamW's first update, made in
    float32, and the running statistics' change by the step) and
    ``levels`` (the first entry's plan)."""
    c, arch = inputs["clouds"][0], Arch(**inputs["arch"])
    lg, loss, grads, stats, levels = step(inputs["weights"], c["xyz"], c["feats"],
                                          c["lengths_host"], c["labels"], c["drop_masks"],
                                          tf32=tf32, arch=arch)
    change = {}
    with torch.no_grad():
        for n, g in grads.items():
            change[n] = adamw_change(inputs["weights"][n], g, inputs["lr"],
                                     inputs["weight_decay"])
        for n, t in stats.items():
            change[n] = t.double() - inputs["weights"][n].double()
    plans = [plan_indices(levels)]
    plans += [plan_indices(plan(e["xyz"], e["lengths_host"], arch))
              for e in inputs["clouds"][1:]]
    return {"plans": plans, "logits": lg, "loss": loss, "grads": grads, "change": change,
            "levels": levels}


def exact_gradient(inputs: dict, levels=None) -> dict:
    """``first_step``'s gradient computed in float64 from the same plan
    (``levels``, computed when None) and masks, by parameter name."""
    c = inputs["clouds"][0]
    return step(inputs["weights"], c["xyz"], c["feats"], c["lengths_host"], c["labels"],
                c["drop_masks"], levels, torch.float64, arch=Arch(**inputs["arch"]))[2]
