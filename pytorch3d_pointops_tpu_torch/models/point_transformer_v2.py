"""Point Transformer V2 semantic segmentation on the port's ops (Wu, Lao,
Jiang, Liu, Zhao, NeurIPS 2022, arXiv:2210.05666; ``PT-v2m2`` of
``pointcept/models/point_transformer_v2/point_transformer_v2m2_base.py`` in
github.com/Pointcept/Pointcept, as its ScanNet configuration
``configs/scannet/semseg-pt-v2m2-0-base.py`` builds it).

A U-Net of five levels whose sizes the data decides: level 0 is the input,
and each encoder stage pools the level above onto a voxel grid
(``GridPool``, ``ops/grid_pool.py``) before its blocks.

=========  =====  ======  ==========  ======  =======================================
Level      Width  Groups  Neighbours  Blocks  Made by
=========  =====  ======  ==========  ======  =======================================
0          48     6       8           1       ``patch_embed``: Linear(9, 48), BN, ReLU
1          96     12      16          2       grid pooling at 0.06 m
2          192    24      16          2       grid pooling at 0.12 m
3          384    48      16          6       grid pooling at 0.24 m
4          512    64      16          2       grid pooling at 0.48 m
decoder    levels 3 to 0 (widths 384, 192, 96, 48; groups 48, 24, 12, 6; 16
           neighbours): ``UnpoolWithSkip`` and one block
head       ReLU(BN(Linear(48, 48))), Linear(48, 20): the logits of every point
=========  =====  ======  ==========  ======  =======================================

The input has 9 channels: each point's xyz, then its ``feats`` (rgb and
normal). ``GroupedVectorAttention`` is grouped vector attention over each
point's K nearest points of its level (itself included), with a learned
position encoding of their offsets added to the relation and the values:

    q = ReLU(BN(Linear(x))), k = ReLU(BN(Linear(x))), v = Linear(x)
    peb = Linear(C, C)(ReLU(BN(Linear(3, C)(p_j - p_i))))
    r = k_j - q_i (* pem, where pe_multiplier) + peb;  v' = v_j + peb
    w = softmax over the K neighbours of Linear(G, G)(ReLU(BN(Linear(C, G)(r))))
    y_i[g * C/G + t] = sum_j v'_j[g * C/G + t] * w_j[g]

so the groups are contiguous channel blocks. ``Block`` wraps it in two
linear maps and a residual whose branch passes through stochastic depth
(``DropPath``: a row kept with probability 1 - rate and scaled by its
inverse). ``UnpoolWithSkip`` ("map") gives every point the projection of
its cluster of the coarser level plus the projection of its own skip
features.

Features are packed, as the source keeps them: the rows of every cloud of
the batch one after another. Every batch norm runs over all rows of its
input, over every (point, neighbour) pair for grouped tensors (Pointcept's
``PointBatchNorm``, kept as a module of that name so that the state names
are the source's), through ``F.batch_norm`` on the module's weights and
statistics, as in ``point_transformer.py``, whose packed helpers this
module shares.

``plan`` is everything that depends on the coordinates alone: the grid
pooling of each level's coordinates into the next (clusters, their order
and their mean coordinates), then each level's KNN at the largest K it
needs, once, for every block of that level, encoder and decoder; a smaller
K is its first columns (the lists are sorted, ties to the lowest index).
Each pooling reads its clusters' counts to the host once
(``sync.grid_pool.counts``): four reads a step at the published depth,
and no other. Features are gathered only through ``masked_gather``, whose
backward is the port's deterministic scatter, and pooled through
``grid_pool_max``, whose backward is an indexed write; so a step on the
card repeats bit for bit.

Departures from the source: a cluster's mean coordinates are its float32
sum in sorted order over its count, and the pooled maximum keeps the first
of equal maxima in sorted order (torch_scatter's ``segment_csr`` leaves both
to its reduction); the KNN keeps the lowest index on equal distances; a
cloud with fewer points at a level than the largest K that level uses
raises ``ValueError`` (the source's KNN pads with -1 and masks the
attention's weights), so the neighbour mask is identically 1 and is not
built; drop path takes masks from the caller where given, so that a step
can be repeated exactly.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import knn_points
from ..ops.grid_pool import GridPool, grid_pool, grid_pool_max
from ..ops.utils import host_ints
from .point_transformer import _bn, _gather, _linear, _packed_neighbours

IN_CHANNELS = 9  # xyz, rgb, normal
CLASSES = 20  # ScanNet
PATCH_EMBED = dict(depth=1, channels=48, groups=6, neighbours=8)
ENC_DEPTHS = (2, 2, 6, 2)
ENC_CHANNELS = (96, 192, 384, 512)
ENC_GROUPS = (12, 24, 48, 64)
ENC_NEIGHBOURS = (16, 16, 16, 16)
DEC_DEPTHS = (1, 1, 1, 1)
DEC_CHANNELS = (48, 96, 192, 384)
DEC_GROUPS = (6, 12, 24, 48)
DEC_NEIGHBOURS = (16, 16, 16, 16)
GRID_SIZES = (0.06, 0.12, 0.24, 0.48)
DROP_PATH_RATE = 0.3
GROUPED_ROWS = "point_transformer_v2.grouped_rows"


class Level(NamedTuple):
    """The plan of one level. T is the level's number of points, packed."""

    lengths: List[int]  # each cloud's points at this level, host ints
    pos: torch.Tensor  # (T, 3) packed coordinates
    rows: torch.Tensor  # (T,) int64: each packed row's row in the padded (N * P, 3) layout
    neighbours: Dict[int, Tuple[torch.Tensor, torch.Tensor]]  # K: (T, K) packed rows of
    # this level, nearest first, and (T, K, 3) their offsets p_j - p_i
    pool: Optional[GridPool]  # this level's pooling into the next; None at the coarsest


class PointBatchNorm(nn.Module):
    """Batch norm over every row of a (T, C) or (T, K, C) input: the
    source's module, whose ``norm`` holds the weights."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.BatchNorm1d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bn(x.reshape(-1, x.shape[-1]), self.norm, self.training).reshape(x.shape)


def _mlp(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    """Linear, PointBatchNorm, ReLU[, Linear] of a ``nn.Sequential`` so built."""
    y = torch.relu_(seq[1](_linear(x, seq[0])))
    return _linear(y, seq[3]) if len(seq) > 3 else y


def _grouped_sum(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[i, g * I + t] = sum_j v[i, j, g * I + t] * w[i, j, g]: v (T, K, C),
    w (T, K, G), groups of I = C / G contiguous channels."""
    T, K, C = v.shape
    G = w.shape[-1]
    return (v.reshape(T, K, G, C // G) * w[..., None]).sum(1).reshape(T, C)


class GroupedVectorAttention(nn.Module):
    """The source's ``GroupedVectorAttention(C, G)`` with its defaults
    (biases on q, k and v, the position encoding's bias path, no attention
    dropout), the multiplier path where ``pe_multiplier``; the module
    docstring has its equations."""

    def __init__(self, channels: int, groups: int, pe_multiplier: bool = False):
        super().__init__()
        if channels % groups:
            raise ValueError(f"channels ({channels}) must be a multiple of groups ({groups})")
        self.groups, self.pe_multiplier = groups, pe_multiplier

        def mlp(fan_in, width, fan_out=None):
            layers = [nn.Linear(fan_in, width), PointBatchNorm(width), nn.ReLU(inplace=True)]
            return nn.Sequential(*layers, *([nn.Linear(width, fan_out)] if fan_out else []))

        self.linear_q = mlp(channels, channels)
        self.linear_k = mlp(channels, channels)
        self.linear_v = nn.Linear(channels, channels)
        if pe_multiplier:
            self.linear_p_multiplier = mlp(3, channels, channels)
        self.linear_p_bias = mlp(3, channels, channels)
        self.weight_encoding = mlp(channels, groups, groups)

    def forward(self, x: torch.Tensor, idx: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        """(T, C) packed features of one level, its (T, K) neighbours and
        their (T, K, 3) offsets -> (T, C)."""
        with tracing.span("point_transformer_v2.attn"):
            T, C = x.shape
            K = idx.shape[1]
            q, k = _mlp(x, self.linear_q), _mlp(x, self.linear_k)
            tracing.count(GROUPED_ROWS, T * K)
            k, v = _gather(torch.cat([k, _linear(x, self.linear_v)], 1), idx).split(C, -1)
            r = k - q[:, None]
            pos = rel.reshape(T * K, 3)
            if self.pe_multiplier:
                r = r * _mlp(pos, self.linear_p_multiplier).reshape(T, K, C)
            peb = _mlp(pos, self.linear_p_bias).reshape(T, K, C)
            w = _mlp((r + peb).reshape(T * K, C), self.weight_encoding)
            return _grouped_sum(v + peb, F.softmax(w.reshape(T, K, -1), dim=1))


class Block(nn.Module):
    """y = ReLU(BN(fc1(x))); y = ReLU(BN(attn(y))); y = BN(fc3(y));
    ReLU(x + DropPath(y)). The linear maps have no bias."""

    def __init__(self, channels: int, groups: int, pe_multiplier: bool = False):
        super().__init__()
        self.attn = GroupedVectorAttention(channels, groups, pe_multiplier)
        self.fc1 = nn.Linear(channels, channels, bias=False)
        self.fc3 = nn.Linear(channels, channels, bias=False)
        self.norm1 = PointBatchNorm(channels)
        self.norm2 = PointBatchNorm(channels)
        self.norm3 = PointBatchNorm(channels)

    def forward(self, x: torch.Tensor, idx: torch.Tensor, rel: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep`` (T,): drop path's factor a row (0 or 1 / (1 - rate)),
        or None for none."""
        y = torch.relu_(self.norm1(_linear(x, self.fc1)))
        y = torch.relu_(self.norm2(self.attn(y, idx, rel)))
        y = self.norm3(_linear(y, self.fc3))
        if keep is not None:
            y = y * keep[:, None]
        return torch.relu_(x + y)


class BlockSequence(nn.Module):
    """``depth`` blocks over one KNN(``neighbours``) of their level."""

    def __init__(self, depth: int, channels: int, groups: int, neighbours: int,
                 pe_multiplier: bool = False):
        super().__init__()
        self.neighbours = neighbours
        self.blocks = nn.ModuleList([Block(channels, groups, pe_multiplier)
                                     for _ in range(depth)])

    def forward(self, x: torch.Tensor, level: Level, name: str,
                masks: Dict[str, torch.Tensor]) -> torch.Tensor:
        idx, rel = level.neighbours[self.neighbours]
        for b, block in enumerate(self.blocks):
            x = block(x, idx, rel, masks.get(f"{name}.blocks.{b}"))
        return x


class GVAPatchEmbed(nn.Module):
    """Level 0: ReLU(BN(Linear(in, C, no bias)(x))), then its blocks."""

    def __init__(self, in_channels: int, channels: int, groups: int, depth: int,
                 neighbours: int, pe_multiplier: bool = False):
        super().__init__()
        self.proj = nn.Sequential(nn.Linear(in_channels, channels, bias=False),
                                  PointBatchNorm(channels), nn.ReLU(inplace=True))
        self.blocks = BlockSequence(depth, channels, groups, neighbours, pe_multiplier)


class GridPoolLayer(nn.Module):
    """The source's ``GridPool``: ReLU(BN(fc(x))) of the level above, then
    each cluster's channel-wise maximum (the clusters are the plan's). The
    linear map has no bias."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.fc = nn.Linear(in_channels, channels, bias=False)
        self.norm = PointBatchNorm(channels)

    def forward(self, x: torch.Tensor, pool: GridPool) -> torch.Tensor:
        with tracing.span("point_transformer_v2.pool"):
            return grid_pool_max(torch.relu_(self.norm(_linear(x, self.fc))), pool)


class UnpoolWithSkip(nn.Module):
    """The source's ``UnpoolWithSkip`` with its "map" backend:
    ReLU(BN(proj(x_coarse)))[cluster] + ReLU(BN(proj_skip(x_skip)))."""

    def __init__(self, in_channels: int, skip_channels: int, channels: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Linear(in_channels, channels), PointBatchNorm(channels),
                                  nn.ReLU(inplace=True))
        self.proj_skip = nn.Sequential(nn.Linear(skip_channels, channels),
                                       PointBatchNorm(channels), nn.ReLU(inplace=True))

    def forward(self, coarse: torch.Tensor, skip: torch.Tensor, pool: GridPool) -> torch.Tensor:
        with tracing.span("point_transformer_v2.unpool"):
            tracing.count(GROUPED_ROWS, skip.shape[0])
            up = _gather(_mlp(coarse, self.proj), pool.cluster[:, None])[:, 0]
            return up + _mlp(skip, self.proj_skip)


class Encoder(nn.Module):
    def __init__(self, depth, in_channels, channels, groups, neighbours, pe_multiplier=False):
        super().__init__()
        self.down = GridPoolLayer(in_channels, channels)
        self.blocks = BlockSequence(depth, channels, groups, neighbours, pe_multiplier)


class Decoder(nn.Module):
    def __init__(self, depth, in_channels, skip_channels, channels, groups, neighbours,
                 pe_multiplier=False):
        super().__init__()
        self.up = UnpoolWithSkip(in_channels, skip_channels, channels)
        self.blocks = BlockSequence(depth, channels, groups, neighbours, pe_multiplier)


class PointTransformerV2Seg(nn.Module):
    """Point Transformer V2 (``PT-v2m2``) semantic segmentation, as
    published by default (the table in the module's docstring). Smaller
    sizes (one entry a stage) serve tests. Module names are the source's:
    ``patch_embed``, ``enc_stages``, ``dec_stages`` (each stage's ``down``
    or ``up`` and its ``blocks``), ``seg_head``."""

    def __init__(self, in_channels: int = IN_CHANNELS, classes: int = CLASSES,
                 patch_embed_depth: int = PATCH_EMBED["depth"],
                 patch_embed_channels: int = PATCH_EMBED["channels"],
                 patch_embed_groups: int = PATCH_EMBED["groups"],
                 patch_embed_neighbours: int = PATCH_EMBED["neighbours"],
                 enc_depths: Sequence[int] = ENC_DEPTHS,
                 enc_channels: Sequence[int] = ENC_CHANNELS,
                 enc_groups: Sequence[int] = ENC_GROUPS,
                 enc_neighbours: Sequence[int] = ENC_NEIGHBOURS,
                 dec_depths: Sequence[int] = DEC_DEPTHS,
                 dec_channels: Sequence[int] = DEC_CHANNELS,
                 dec_groups: Sequence[int] = DEC_GROUPS,
                 dec_neighbours: Sequence[int] = DEC_NEIGHBOURS,
                 grid_sizes: Sequence[float] = GRID_SIZES,
                 drop_path_rate: float = DROP_PATH_RATE,
                 pe_multiplier: bool = False):
        super().__init__()
        stages = len(enc_depths)
        per_stage = (enc_channels, enc_groups, enc_neighbours, dec_depths, dec_channels,
                     dec_groups, dec_neighbours, grid_sizes)
        if stages < 1 or any(len(t) != stages for t in per_stage):
            raise ValueError("every encoder and decoder size needs one entry a stage")
        if in_channels < 3:
            raise ValueError("in_channels counts the 3 coordinates first")
        self.in_channels, self.classes = in_channels, classes
        self.grid_sizes = tuple(float(g) for g in grid_sizes)
        self.drop_path_rate = float(drop_path_rate)
        self.patch_embed = GVAPatchEmbed(in_channels, patch_embed_channels, patch_embed_groups,
                                         patch_embed_depth, patch_embed_neighbours, pe_multiplier)
        enc = [patch_embed_channels, *enc_channels]
        dec = [*dec_channels, enc[-1]]
        self.enc_stages = nn.ModuleList([
            Encoder(enc_depths[i], enc[i], enc[i + 1], enc_groups[i], enc_neighbours[i],
                    pe_multiplier) for i in range(stages)])
        self.dec_stages = nn.ModuleList([
            Decoder(dec_depths[i], dec[i + 1], enc[i], dec[i], dec_groups[i], dec_neighbours[i],
                    pe_multiplier) for i in range(stages)])
        self.seg_head = nn.Sequential(nn.Linear(dec[0], dec[0]), PointBatchNorm(dec[0]),
                                      nn.ReLU(inplace=True), nn.Linear(dec[0], classes))
        # The K each level's blocks use: level 0 the patch embedding's and
        # the first decoder stage's, level i + 1 encoder stage i's and
        # decoder stage i + 1's.
        self.level_neighbours = [{patch_embed_neighbours, dec_neighbours[0]}] + [
            {enc_neighbours[i]} | ({dec_neighbours[i + 1]} if i + 1 < stages else set())
            for i in range(stages)]

    def drop_path_rates(self) -> Dict[str, float]:
        """Each block's drop path rate, by the block's module name, where it
        is above 0: linear from 0 to ``drop_path_rate`` over the encoder's
        blocks in order, and again over the decoder's, stage 0 first (the
        source's ``torch.linspace``); the patch embedding's blocks take 0."""
        rates = {}
        for kind, stages in (("enc_stages", self.enc_stages), ("dec_stages", self.dec_stages)):
            names = [f"{kind}.{i}.blocks.blocks.{b}" for i, s in enumerate(stages)
                     for b in range(len(s.blocks.blocks))]
            line = torch.linspace(0, self.drop_path_rate, len(names)).tolist()
            rates.update({n: r for n, r in zip(names, line) if r > 0})
        return rates

    def block_levels(self) -> Dict[str, int]:
        """The level of every block, by the block's module name."""
        out = {f"patch_embed.blocks.blocks.{b}": 0
               for b in range(len(self.patch_embed.blocks.blocks))}
        for kind, stages, shift in (("enc_stages", self.enc_stages, 1),
                                    ("dec_stages", self.dec_stages, 0)):
            for i, s in enumerate(stages):
                out.update({f"{kind}.{i}.blocks.blocks.{b}": i + shift
                            for b in range(len(s.blocks.blocks))})
        return out

    def drop_masks(self, plan: List[Level], generator=None) -> Dict[str, torch.Tensor]:
        """Drop path's factors for one step, by block name: a row kept with
        probability 1 - rate and then scaled by 1 / (1 - rate), else 0
        (timm's ``DropPath`` over the rows of packed points)."""
        levels, out = self.block_levels(), {}
        for name, rate in self.drop_path_rates().items():
            pos = plan[levels[name]].pos
            keep = 1.0 - rate
            draw = torch.rand(pos.shape[0], generator=generator, device=pos.device)
            out[name] = (draw < keep).to(torch.float32) / keep
        return out

    def _check(self, level: int, lengths: List[int]) -> None:
        need = max(self.level_neighbours[level])
        if min(lengths, default=need) < need:
            raise ValueError(f"level {level} needs clouds of at least {need} points "
                             f"(got lengths {lengths})")

    @torch.no_grad()
    def plan(self, xyz: torch.Tensor, lengths_host: Sequence[int]) -> List[Level]:
        """Every level's pooling and neighbours (``Level``) for clouds
        ``xyz`` (N, P, 3) with valid lengths ``lengths_host`` (host ints).
        Raises ``ValueError`` where a cloud has fewer points at a level than
        the largest K that level uses."""
        with tracing.span("point_transformer_v2.plan"):
            N, dev = xyz.shape[0], xyz.device
            lengths = [int(n) for n in lengths_host]
            self._check(0, lengths)
            padded = xyz.to(torch.float32).contiguous()
            pool, grids, levels, layouts = None, list(self.grid_sizes), [], []
            while True:
                # The level's lengths and first rows on the device, each
                # packed row's row in its padded layout, its coordinates
                # packed and padded.
                ints = host_ints(lengths + [sum(lengths[:n]) for n in range(N)], dev)
                lens_d, first = ints[:N], ints[N:]
                T, P = sum(lengths), padded.shape[1] if pool is None else max(lengths)
                rows = torch.arange(T, device=dev) + torch.repeat_interleave(
                    torch.arange(N, device=dev) * P - first, lens_d, output_size=T)
                if pool is None:
                    pos = _gather(padded.reshape(-1, 3), rows[:, None])[:, 0]
                else:
                    pos = pool.pos
                    padded = pos.new_zeros((N * P, 3)).index_copy_(0, rows, pos).reshape(N, P, 3)
                pool = grid_pool(pos, lengths, grids.pop(0)) if grids else None
                levels.append(Level(lengths, pos, rows, {}, pool))
                layouts.append((padded, lens_d, first))
                if pool is None:
                    break
                lengths = pool.lengths
                self._check(len(levels), lengths)
            # Every KNN after every pooling, so that each pooling's read
            # waits on a short queue.
            for level, (pts, lens_d, first), ks in zip(levels, layouts, self.level_neighbours):
                K = max(ks)
                idx = knn_points(pts, pts, lens_d, lens_d, K=K).idx
                nbr = _packed_neighbours(idx, level.rows, first)
                rel = _gather(level.pos, nbr) - level.pos[:, None]
                level.neighbours.update({k: (nbr[:, :k].contiguous(), rel[:, :k].contiguous())
                                         for k in ks if k < K})
                level.neighbours[K] = (nbr, rel)
            return levels

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, lengths_host: Sequence[int],
                plan: Optional[List[Level]] = None,
                drop_masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """(T, classes) logits of every valid point, packed cloud after
        cloud, of clouds ``xyz`` (N, P, 3) with features ``feats`` (N, P,
        in_channels - 3) and valid lengths ``lengths_host`` (host ints).
        ``plan`` is ``self.plan(xyz, lengths_host)``, computed here when
        None. ``drop_masks`` holds drop path's factor a row by block name
        (``drop_masks``); when None, a module in training mode draws its
        own and one in eval mode drops nothing."""
        if plan is None:
            plan = self.plan(xyz, lengths_host)
        if [int(n) for n in lengths_host] != plan[0].lengths:
            raise ValueError("the plan was made for other lengths")
        if drop_masks is None:
            drop_masks = self.drop_masks(plan) if self.training else {}
        N, P, _ = xyz.shape
        x = torch.cat([xyz, feats], -1).to(torch.float32).reshape(N * P, -1)
        x = _gather(x, plan[0].rows[:, None])[:, 0]
        x = _mlp(x, self.patch_embed.proj)
        x = self.patch_embed.blocks(x, plan[0], "patch_embed.blocks", drop_masks)
        skips = [x]
        for i, stage in enumerate(self.enc_stages):
            x = stage.down(x, plan[i].pool)
            x = stage.blocks(x, plan[i + 1], f"enc_stages.{i}.blocks", drop_masks)
            skips.append(x)
        for i in reversed(range(len(self.dec_stages))):
            stage = self.dec_stages[i]
            x = stage.up(x, skips[i], plan[i].pool)
            x = stage.blocks(x, plan[i], f"dec_stages.{i}.blocks", drop_masks)
        with tracing.span("point_transformer_v2.head"):
            return _mlp(x, self.seg_head)
