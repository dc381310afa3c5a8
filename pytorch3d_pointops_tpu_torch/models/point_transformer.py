"""Point Transformer semantic segmentation on the port's ops (Zhao, Jiang,
Jia, Torr, Koltun, ICCV 2021, arXiv:2012.09164; ``pointtransformer_seg_repro``
of ``model/pointtransformer/pointtransformer_seg.py`` in
github.com/hszhao/point-transformer).

A U-Net of five levels over ragged batches of clouds:

=======  =====  ======  ========  ======  ===========================================
Level    Width  Stride  nsample   Blocks  Encoder / decoder
=======  =====  ======  ========  ======  ===========================================
1        32     1       8         1       ``TransitionDown`` (a linear map), blocks
2        64     4       16        2       FPS of L // 4 of each cloud, then
3        128    4       16        3       ``TransitionDown`` (grouped linear map, max
4        256    4       16        5       over the nsample nearest points of the
5        512    4       16        2       level above), blocks
decoder  every level, coarsest first: a ``TransitionUp`` and one block
head     ReLU(BN(Linear(32, 32))), Linear(32, 13): the logits of every point
=======  =====  ======  ========  ======  ===========================================

The input has 6 channels: each point's xyz, then its ``feats`` (rgb), as the
source's ``c == 6`` path. ``PointTransformerLayer`` is vector attention over
each point's nsample nearest points of its level (itself included), with a
learned position encoding of their offsets; ``PointTransformerBlock`` wraps
it in two linear maps and a residual; ``TransitionUp`` adds each point's
interpolation from the 3 nearest points of the coarser level (inverse
distance weights), or at the coarsest level each cloud's mean.

Features are packed, as the source keeps them: the rows of every cloud of
the batch one after another (``Level.rows``), so that each batch norm sees
the valid rows alone. Every ``nn.BatchNorm1d`` runs over all rows of its
input, over every (point, neighbour) pair for grouped tensors, and is
applied by ``F.batch_norm`` on the module's weights and running statistics
(the module's own call would also count ``num_batches_tracked``, a launch
each that a fixed momentum never reads). Coordinates stay padded (N, P, 3)
with their lengths for the port's FPS and KNN, whose indices become packed
rows by adding each cloud's first packed row.

``plan`` is everything that depends on the coordinates alone: the FPS
indices of each sampled level, and the KNN of every level (each point's
nsample nearest points of its own level, of the level above for a
``TransitionDown``, and its 3 nearest of the next coarser level, with their
squared distances), each computed once and used by every layer of its
level, encoder and decoder (the source queries them again in each layer).
Features are gathered only through ``masked_gather``, whose backward is the
port's deterministic scatter; the per-cloud means of the coarsest level are
sums over slices. So a step on the card repeats bit for bit, and neither
``plan`` nor ``forward`` reads a value back to the host: the lengths travel
as host ints, and the device copies of them go through pinned memory.

Departures from the source: FPS starts at each cloud's first point and
keeps the first of equal maxima, and the KNN keeps the lowest index on equal
distances (the port's rules; the source's CUDA kernels leave both to their
reductions); a cloud with fewer points than a level's nsample raises
``ValueError`` (the source's KNN repeats points there).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import knn_points, masked_gather, sample_farthest_points
from ..ops.utils import host_ints

IN_CHANNELS = 6  # xyz and rgb
CLASSES = 13  # S3DIS
PLANES = (32, 64, 128, 256, 512)
STRIDES = (1, 4, 4, 4, 4)
NSAMPLE = (8, 16, 16, 16, 16)
BLOCKS = (1, 2, 3, 5, 2)  # after each TransitionDown (the source's [2, 3, 4, 6, 3] less one)
SHARE_PLANES = 8
UP_K = 3  # the coarser points a TransitionUp interpolates from
GROUPED_ROWS = "point_transformer.grouped_rows"


class Level(NamedTuple):
    """The plan of one level. T is the level's number of points, packed."""

    lengths: List[int]  # each cloud's points at this level, host ints
    xyz: torch.Tensor  # (N, P, 3) padded coordinates, zero rows past each length
    rows: torch.Tensor  # (T,) int64: each packed row's row in xyz.reshape(-1, 3)
    pos: torch.Tensor  # (T, 3) packed coordinates
    fps_idx: Optional[torch.Tensor]  # (N, P) FPS indices into the level above, -1 past L
    down_idx: Optional[torch.Tensor]  # (T, nsample) packed rows of the level above
    down_rel: Optional[torch.Tensor]  # (T, nsample, 3) their offsets p_j - p_i
    nbr_idx: torch.Tensor  # (T, nsample) packed rows of this level, nearest first
    nbr_rel: torch.Tensor  # (T, nsample, 3) their offsets p_j - p_i
    up_idx: Optional[torch.Tensor]  # (T, 3) packed rows of the next coarser level
    up_dist: Optional[torch.Tensor]  # (T, 3) their squared distances


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Packed rows ``x[idx]`` (idx of any shape, every entry a valid row)
    by ``masked_gather``, whose backward is the deterministic scatter."""
    return masked_gather(x[None], idx.reshape(1, -1, idx.shape[-1]))[0].reshape(
        *idx.shape, x.shape[-1])


def _bn(x: torch.Tensor, norm: nn.BatchNorm1d, training: bool) -> torch.Tensor:
    return F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                        training, norm.momentum, norm.eps)


def _linear(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    return F.linear(x, linear.weight, linear.bias)


def _packed_neighbours(idx: torch.Tensor, rows: torch.Tensor, first: torch.Tensor):
    """Padded KNN indices (N, P, K) into each cloud as packed rows (T, K) of
    the target level, whose clouds begin at packed rows ``first`` (N,)."""
    N, P, K = idx.shape
    return (idx + first[:, None, None]).reshape(N * P, K)[rows]


class PointTransformerLayer(nn.Module):
    """Vector self-attention over each point's nsample nearest points, as
    the source's ``PointTransformerLayer(planes, planes, share_planes,
    nsample)`` (names of its modules kept):

        q, k, v = linear_q(x), linear_k(x), linear_v(x)
        p_r = linear_p(p_j - p_i)       Linear(3, 3), BN, ReLU, Linear(3, C)
        w = linear_w(k_j - q_i + p_r)   BN, ReLU, Linear(C, C/s), BN, ReLU, Linear(C/s, C/s)
        w = softmax over the nsample neighbours
        y_i[c] = sum_j (v_j + p_r)[c] * w[c mod C/s]
    """

    def __init__(self, planes: int, share_planes: int = SHARE_PLANES):
        super().__init__()
        if planes % share_planes:
            raise ValueError(f"planes ({planes}) must be a multiple of share_planes "
                             f"({share_planes})")
        self.share_planes = share_planes
        mid = planes // share_planes
        self.linear_q = nn.Linear(planes, planes)
        self.linear_k = nn.Linear(planes, planes)
        self.linear_v = nn.Linear(planes, planes)
        self.linear_p = nn.Sequential(nn.Linear(3, 3), nn.BatchNorm1d(3), nn.ReLU(inplace=True),
                                      nn.Linear(3, planes))
        self.linear_w = nn.Sequential(nn.BatchNorm1d(planes), nn.ReLU(inplace=True),
                                      nn.Linear(planes, mid), nn.BatchNorm1d(mid),
                                      nn.ReLU(inplace=True), nn.Linear(mid, mid))

    def forward(self, x: torch.Tensor, level: Level) -> torch.Tensor:
        """(T, C) packed features of one level -> (T, C)."""
        with tracing.span("point_transformer.attn"):
            T, C = x.shape
            K = level.nbr_idx.shape[1]
            s, train = self.share_planes, self.training
            lp, lw = self.linear_p, self.linear_w
            q = _linear(x, self.linear_q)
            kv = torch.cat([_linear(x, self.linear_k), _linear(x, self.linear_v)], 1)
            tracing.count(GROUPED_ROWS, T * K)
            k, v = _gather(kv, level.nbr_idx).split(C, -1)
            p = torch.relu_(_bn(_linear(level.nbr_rel.reshape(T * K, 3), lp[0]), lp[1], train))
            p = _linear(p, lp[3]).reshape(T, K, C)
            w = (k - q[:, None]) + p
            w = torch.relu_(_bn(w.reshape(T * K, C), lw[0], train))
            w = torch.relu_(_bn(_linear(w, lw[2]), lw[3], train))
            w = F.softmax(_linear(w, lw[5]).reshape(T, K, C // s), dim=1)
            return ((v + p).reshape(T, K, s, C // s) * w[:, :, None]).sum(1).reshape(T, C)


class PointTransformerBlock(nn.Module):
    """y = ReLU(BN(linear1(x))); y = ReLU(BN(attention(y))); y =
    BN(linear3(y)); ReLU(y + x). The linear maps have no bias."""

    def __init__(self, planes: int, share_planes: int = SHARE_PLANES):
        super().__init__()
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = nn.BatchNorm1d(planes)
        self.transformer2 = PointTransformerLayer(planes, share_planes)
        self.bn2 = nn.BatchNorm1d(planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = nn.BatchNorm1d(planes)

    def forward(self, x: torch.Tensor, level: Level) -> torch.Tensor:
        train = self.training
        y = torch.relu_(_bn(_linear(x, self.linear1), self.bn1, train))
        y = torch.relu_(_bn(self.transformer2(y, level), self.bn2, train))
        return torch.relu_(_bn(_linear(y, self.linear3), self.bn3, train) + x)


class TransitionDown(nn.Module):
    """Stride 1: ReLU(BN(linear(x))). Stride s > 1: for each point of the
    level (FPS of the level above, ``plan``), its nsample nearest points of
    the level above as [p_j - p_i, x_j], a linear map, BN, ReLU, and the max
    over them. The linear map has no bias."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.linear = nn.Linear(in_planes if stride == 1 else 3 + in_planes, planes, bias=False)
        self.bn = nn.BatchNorm1d(planes)

    def forward(self, x: torch.Tensor, level: Level) -> torch.Tensor:
        """(T_above, C_in) packed features of the level above -> (T, C)."""
        with tracing.span("point_transformer.down"):
            if self.stride == 1:
                return torch.relu_(_bn(_linear(x, self.linear), self.bn, self.training))
            T, K = level.down_idx.shape
            tracing.count(GROUPED_ROWS, T * K)
            g = torch.cat([level.down_rel, _gather(x, level.down_idx)], -1)
            y = torch.relu_(_bn(_linear(g.reshape(T * K, -1), self.linear), self.bn,
                                self.training))
            return y.reshape(T, K, -1).max(1).values


class TransitionUp(nn.Module):
    """``out_planes=None`` (the coarsest level): each point's features
    beside ReLU(linear2(its cloud's mean)), then ReLU(BN(linear1(.))).
    Else ReLU(BN(linear1(x))) plus the interpolation of ReLU(BN(linear2(
    x_coarse))) from each point's 3 nearest coarser points, weighted by
    1 / (distance + 1e-8) and normalised to sum 1."""

    def __init__(self, in_planes: int, out_planes: Optional[int] = None):
        super().__init__()
        if out_planes is None:
            self.linear1 = nn.Sequential(nn.Linear(2 * in_planes, in_planes),
                                         nn.BatchNorm1d(in_planes), nn.ReLU(inplace=True))
            self.linear2 = nn.Sequential(nn.Linear(in_planes, in_planes), nn.ReLU(inplace=True))
        else:
            self.linear1 = nn.Sequential(nn.Linear(out_planes, out_planes),
                                         nn.BatchNorm1d(out_planes), nn.ReLU(inplace=True))
            self.linear2 = nn.Sequential(nn.Linear(in_planes, out_planes),
                                         nn.BatchNorm1d(out_planes), nn.ReLU(inplace=True))
        self.head = out_planes is None

    def forward(self, x: torch.Tensor, level: Level,
                coarse: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(T, C) packed features of this level (and (T_coarse, C_in) of the
        next coarser level) -> (T, C)."""
        train = self.training
        l1, l2 = self.linear1, self.linear2
        with tracing.span("point_transformer.up"):
            if self.head:
                parts = x.split(level.lengths)
                means = torch.stack([part.sum(0) / part.shape[0] for part in parts])
                g = torch.relu_(_linear(means, l2[0]))
                g = torch.cat([g[n:n + 1].expand(len(part), -1) for n, part in enumerate(parts)])
                return torch.relu_(_bn(_linear(torch.cat([x, g], 1), l1[0]), l1[1], train))
            y = torch.relu_(_bn(_linear(x, l1[0]), l1[1], train))
            c = torch.relu_(_bn(_linear(coarse, l2[0]), l2[1], train))
            with torch.no_grad():
                w = 1.0 / (torch.sqrt(level.up_dist) + 1e-8)
                w = w / w.sum(1, keepdim=True)
            tracing.count(GROUPED_ROWS, level.up_idx.numel())
            return y + (_gather(c, level.up_idx) * w[..., None]).sum(1)


class PointTransformerSeg(nn.Module):
    """Point Transformer semantic segmentation, as published by default
    (the table in the module's docstring). Smaller ``planes``, ``nsample``,
    ``strides`` and ``blocks`` (one entry a level) serve tests; the first
    stride must be 1 and every other above 1. Module names are the
    source's: ``enc1``-``enc5``, ``dec5``-``dec1`` (each a
    ``TransitionDown`` or ``TransitionUp`` and then its blocks), ``cls``."""

    def __init__(self, in_channels: int = IN_CHANNELS, classes: int = CLASSES,
                 planes: Sequence[int] = PLANES, strides: Sequence[int] = STRIDES,
                 nsample: Sequence[int] = NSAMPLE, blocks: Sequence[int] = BLOCKS,
                 share_planes: int = SHARE_PLANES):
        super().__init__()
        if not len(planes) == len(strides) == len(nsample) == len(blocks) >= 1:
            raise ValueError("planes, strides, nsample and blocks need one entry a level")
        if strides[0] != 1 or min(strides[1:], default=2) < 2:
            raise ValueError(f"strides must be 1 and then above 1 (got {tuple(strides)})")
        if in_channels < 3:
            raise ValueError("in_channels counts the 3 coordinates first")
        self.in_channels, self.classes = in_channels, classes
        self.planes, self.strides = tuple(planes), tuple(strides)
        self.nsample, self.blocks = tuple(nsample), tuple(blocks)
        levels = len(planes)
        width = in_channels
        for i in range(levels):
            enc = [TransitionDown(width, planes[i], strides[i])]
            enc += [PointTransformerBlock(planes[i], share_planes) for _ in range(blocks[i])]
            setattr(self, f"enc{i + 1}", nn.ModuleList(enc))
            width = planes[i]
        for i in reversed(range(levels)):
            up = TransitionUp(planes[i]) if i == levels - 1 else TransitionUp(planes[i + 1],
                                                                               planes[i])
            setattr(self, f"dec{i + 1}",
                    nn.ModuleList([up, PointTransformerBlock(planes[i], share_planes)]))
        self.cls = nn.Sequential(nn.Linear(planes[0], planes[0]), nn.BatchNorm1d(planes[0]),
                                 nn.ReLU(inplace=True), nn.Linear(planes[0], classes))

    def level_lengths(self, lengths_host: Sequence[int]) -> List[List[int]]:
        """Each level's cloud lengths from the input's (host ints): FPS
        keeps L // stride points of a cloud of L. Raises ``ValueError``
        where a cloud has fewer points than a level's nsample (or than the
        3 a ``TransitionUp`` interpolates from)."""
        lengths = [[int(n) for n in lengths_host]]
        for s in self.strides[1:]:
            lengths.append([n // s for n in lengths[-1]])
        for i, (lens, k) in enumerate(zip(lengths, self.nsample)):
            need = k if i == 0 else max(k, UP_K)
            if min(lens, default=need) < need:
                raise ValueError(f"level {i + 1} needs clouds of at least {need} points "
                                 f"(got lengths {lens}; input lengths {lengths[0]})")
        return lengths

    @torch.no_grad()
    def plan(self, xyz: torch.Tensor, lengths_host: Sequence[int]) -> List[Level]:
        """Every level's sampling and neighbours (``Level``) for clouds
        ``xyz`` (N, P, 3) with valid lengths ``lengths_host`` (host ints)."""
        with tracing.span("point_transformer.plan"):
            lengths = self.level_lengths(lengths_host)
            N, dev = xyz.shape[0], xyz.device
            firsts = [[sum(lens[:n]) for n in range(N)] for lens in lengths]
            ints = host_ints([v for lens, first in zip(lengths, firsts) for v in lens + first],
                              dev).reshape(len(lengths), 2, N)
            xyz = xyz.to(torch.float32).contiguous()
            levels: List[Level] = []
            for i, lens in enumerate(lengths):
                lens_d, first = ints[i]
                fps_idx = down_idx = down_rel = None
                if i:
                    above = levels[-1]
                    xyz, fps_idx = sample_farthest_points(above.xyz, ints[i - 1][0], K=lens)
                P, T = xyz.shape[1], sum(lens)
                shift = torch.arange(N, device=dev) * P - first
                rows = torch.arange(T, device=dev) + torch.repeat_interleave(
                    shift, lens_d, output_size=T)
                pos = _gather(xyz.reshape(-1, 3), rows[:, None])[:, 0]
                if i:
                    idx = knn_points(xyz, above.xyz, lens_d, ints[i - 1][0],
                                     K=self.nsample[i]).idx
                    down_idx = _packed_neighbours(idx, rows, ints[i - 1][1])
                    down_rel = _gather(above.pos, down_idx) - pos[:, None]
                idx = knn_points(xyz, xyz, lens_d, lens_d, K=self.nsample[i]).idx
                nbr_idx = _packed_neighbours(idx, rows, first)
                levels.append(Level(lens, xyz, rows, pos, fps_idx, down_idx, down_rel, nbr_idx,
                                    _gather(pos, nbr_idx) - pos[:, None], None, None))
            for i in range(len(levels) - 1):
                fine, coarse = levels[i], levels[i + 1]
                nn_ = knn_points(fine.xyz, coarse.xyz, ints[i][0], ints[i + 1][0], K=UP_K)
                levels[i] = fine._replace(
                    up_idx=_packed_neighbours(nn_.idx, fine.rows, ints[i + 1][1]),
                    up_dist=nn_.dists.reshape(-1, UP_K)[fine.rows])
            return levels

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, lengths_host: Sequence[int],
                plan: Optional[List[Level]] = None) -> torch.Tensor:
        """(T, classes) logits of every valid point, packed cloud after
        cloud, of clouds ``xyz`` (N, P, 3) with features ``feats`` (N, P,
        in_channels - 3) and valid lengths ``lengths_host`` (host ints);
        ``plan`` is ``self.plan(xyz, lengths_host)``, computed here when
        None."""
        if plan is None:
            plan = self.plan(xyz, lengths_host)
        if [int(n) for n in lengths_host] != plan[0].lengths:
            raise ValueError("the plan was made for other lengths")
        N, P, _ = xyz.shape
        x = torch.cat([xyz, feats], -1).to(torch.float32).reshape(N * P, -1)
        x = _gather(x, plan[0].rows[:, None])[:, 0]
        skips = []
        for i, level in enumerate(plan):
            enc = getattr(self, f"enc{i + 1}")
            x = enc[0](x, level)
            for block in enc[1:]:
                x = block(x, level)
            skips.append(x)
        for i in reversed(range(len(plan))):
            up, block = getattr(self, f"dec{i + 1}")
            x = up(skips[i], plan[i], None if i == len(plan) - 1 else x)
            x = block(x, plan[i])
        with tracing.span("point_transformer.head"):
            c = self.cls
            x = torch.relu_(_bn(_linear(x, c[0]), c[1], self.training))
            return _linear(x, c[3])
