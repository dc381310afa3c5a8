"""PointNet++ SSG classification on the port's ops (Qi, Yi, Su, Guibas,
NeurIPS 2017, arXiv:1706.02413; the network of ``models/pointnet2_cls_ssg.py``
in github.com/charlesq34/pointnet2).

Three set-abstraction levels, then a classifier head:

=====  ===========================================  ==========================
Level  Sampling and grouping                        Shared MLP, max over group
=====  ===========================================  ==========================
SA1    FPS 512 of the cloud; ball r = 0.2, 32       64, 64, 128
       a group; centred grouped xyz (3)
SA2    FPS 128 of SA1's 512; ball r = 0.4, 64 a     128, 128, 256
       group; centred xyz (3) + SA1's features
SA3    every point of SA2, xyz not centred (3) +    256, 512, 1024
       SA2's features
head   FC 512, BN, ReLU, dropout 0.5; FC 256, BN, ReLU, dropout 0.5; FC 40
=====  ===========================================  ==========================

A shared MLP layer is a 1x1 convolution with bias, a batch norm and a ReLU.
Here it is a linear map over the last axis of channels-last float32
activations (an ``nn.Linear``'s weights; cuBLAS, deterministic from run to
run), then a batch norm over the flattened (positions, channels) rows (an
``nn.BatchNorm1d``'s weights and running statistics, momentum 0.1; its
``num_batches_tracked`` is not counted).

``plan`` is the sampling and grouping of SA1 and SA2: ``sample_farthest_points``
(start at index 0, ties to the first index) and ``ball_query`` (the first
``nsample`` points in scan order strictly inside the radius). A ball slot
left empty takes the group's first neighbour, as the original's
``query_ball_point`` fills it; slot 0 always holds a point, since a centre
lies in its own ball. The plan depends on the coordinates alone and carries
no gradient, so a caller may compute it ahead of ``forward``.

``forward`` groups with ``masked_gather`` (its backward is the port's
deterministic scatter), centres the grouped xyz, puts them before the
features, and runs the MLPs, the max pooling and the head. Dropout draws
its masks from the caller's ``generator``, so a step can be repeated bit for
bit. Neither ``plan`` nor ``forward`` reads a tensor's value to the host.

Clouds may be ragged (``lengths``). A cloud shorter than SA1's ``npoint``
gives padding centres (zero rows, FPS index -1) whose groups are empty;
they still enter the batch norms' statistics and SA3's max, as they would in
any fixed-size batch. The published model samples clouds of equal size.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import ball_query, masked_gather, sample_farthest_points

CLASSES = 40  # ModelNet40
# SA1 and SA2: (input feature channels, shared MLP widths, FPS centres, ball
# radius, group size); SA3 groups every point of SA2.
SAMPLED = ((0, (64, 64, 128), 512, 0.2, 32), (128, (128, 128, 256), 128, 0.4, 64))
GROUP_ALL = (256, (256, 512, 1024))
HEAD = (1024, 512, 256)  # the FC layers' widths before the logits
KEEP = 0.5  # the head's dropout keeps half of its units, as published


class Level(NamedTuple):
    """The plan of one sampled level."""

    fps_idx: torch.Tensor  # (N, S) int64 indices of the centres, -1 past a cloud's length
    centres: torch.Tensor  # (N, S, 3) the centres' coordinates, zero rows at padding
    group_idx: torch.Tensor  # (N, S, K) int64 ball indices, empty slots filled from slot 0


def fill_empty_slots(idx: torch.Tensor) -> torch.Tensor:
    """-1 ball slots set to the group's slot 0, as ``query_ball_point``
    fills them (a group with no point at all stays -1)."""
    return torch.where(idx < 0, idx[..., :1], idx)


def _layer(x: torch.Tensor, linear: nn.Linear, norm: nn.BatchNorm1d, training: bool):
    """ReLU(batch norm(linear(x))), by the functional ops on the modules'
    weights and running statistics: ``nn.BatchNorm1d``'s own call would
    also count ``num_batches_tracked``, a launch a layer that a fixed
    momentum never reads."""
    x = F.linear(x, linear.weight, linear.bias)
    x = F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                     training, norm.momentum, norm.eps)
    return torch.relu_(x)


class SetAbstraction(nn.Module):
    """One set-abstraction level: group, a shared MLP over every grouped
    point, then the max over each group.

    Args:
        in_channels: feature channels of the level's input points (0 for
            coordinates alone); 3 coordinate channels come before them.
        widths: the shared MLP's output widths.
        npoint, radius, nsample: FPS centres, ball radius and group size;
            ``npoint=None`` groups every input point around the origin
            (coordinates not centred).
    """

    def __init__(self, in_channels: int, widths: Sequence[int],
                 npoint: Optional[int] = None, radius: Optional[float] = None,
                 nsample: Optional[int] = None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        chans = [in_channels + 3, *widths]
        self.linears = nn.ModuleList(nn.Linear(a, b) for a, b in zip(chans, chans[1:]))
        self.norms = nn.ModuleList(nn.BatchNorm1d(b) for b in widths)

    @torch.no_grad()
    def sample(self, xyz: torch.Tensor, lengths: Optional[torch.Tensor]
               ) -> Tuple[Level, Optional[torch.Tensor]]:
        """This level's plan from its input points, and the centres'
        lengths (the next level's input lengths)."""
        centres, fps_idx = sample_farthest_points(xyz, lengths, K=self.npoint)
        held = None if lengths is None else lengths.clamp(max=self.npoint)
        idx = ball_query(centres, xyz, lengths1=held, lengths2=lengths, K=self.nsample,
                         radius=self.radius, return_nn=False).idx
        return Level(fps_idx, centres, fill_empty_slots(idx)), held

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                level: Optional[Level] = None) -> torch.Tensor:
        """(N, S, widths[-1]) features of the level's centres from input
        points ``xyz`` (N, P, 3) and ``features`` (N, P, C) or None, with
        this level's ``Level`` plan (None where it groups every point)."""
        with tracing.span("pointnet2.group"):
            if level is None:
                grouped = xyz if features is None else torch.cat([xyz, features], -1)
                grouped = grouped[:, None]
            else:
                grouped = masked_gather(xyz, level.group_idx) - level.centres[:, :, None, :]
                if features is not None:
                    grouped = torch.cat([grouped, masked_gather(features, level.group_idx)], -1)
        N, S, K, C = grouped.shape
        with tracing.span("pointnet2.mlp"):
            x = grouped.reshape(N * S * K, C)
            for linear, norm in zip(self.linears, self.norms):
                x = _layer(x, linear, norm, self.training)
        with tracing.span("pointnet2.pool"):
            return x.reshape(N, S, K, -1).max(dim=2).values


class PointNet2ClsSSG(nn.Module):
    """PointNet++ SSG classifier, as published (the table in the module's
    docstring: ``SAMPLED``, ``GROUP_ALL``, ``HEAD``, ``CLASSES``)."""

    def __init__(self):
        super().__init__()
        self.sa1, self.sa2 = (SetAbstraction(*level) for level in SAMPLED)
        self.sa3 = SetAbstraction(*GROUP_ALL)
        self.fc1, self.bn1 = nn.Linear(HEAD[0], HEAD[1]), nn.BatchNorm1d(HEAD[1])
        self.fc2, self.bn2 = nn.Linear(HEAD[1], HEAD[2]), nn.BatchNorm1d(HEAD[2])
        self.fc3 = nn.Linear(HEAD[2], CLASSES)

    @torch.no_grad()
    def plan(self, xyz: torch.Tensor, lengths: Optional[torch.Tensor] = None
             ) -> Tuple[Level, Level]:
        """SA1's and SA2's sampling and grouping of clouds ``xyz`` (N, P, 3)
        with valid ``lengths`` (N,) (default all P)."""
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=xyz.device)
        with tracing.span("pointnet2.plan"):
            level1, held = self.sa1.sample(xyz, lengths)
            level2, _ = self.sa2.sample(level1.centres, held)
        return level1, level2

    def dropout_masks(self, batch: int, device, generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The head's two dropout masks, (batch, 512) then (batch, 256), in
        the order they are drawn from ``generator``: Bernoulli draws of
        keeping (``KEEP``), divided by that probability."""
        return tuple(torch.empty((batch, width), device=device)
                     .bernoulli_(KEEP, generator=generator).div_(KEEP)
                     for width in (self.fc1.out_features, self.fc2.out_features))

    def forward(self, xyz: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                plan: Optional[Tuple[Level, Level]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, CLASSES) logits of clouds ``xyz`` (N, P, 3) with valid
        ``lengths``; ``plan`` is ``self.plan(xyz, lengths)``, computed here
        when None. In training, dropout draws from ``generator`` (default:
        torch's default generator of the device)."""
        if plan is None:
            plan = self.plan(xyz, lengths)
        level1, level2 = plan
        f1 = self.sa1(xyz, None, level1)
        f2 = self.sa2(level1.centres, f1, level2)
        f3 = self.sa3(level2.centres, f2)
        with tracing.span("pointnet2.head"):
            x = f3.reshape(f3.shape[0], -1)
            masks = (self.dropout_masks(x.shape[0], x.device, generator)
                     if self.training else (None, None))
            for fc, bn, mask in ((self.fc1, self.bn1, masks[0]), (self.fc2, self.bn2, masks[1])):
                x = _layer(x, fc, bn, self.training)
                if mask is not None:
                    x = x * mask
            return self.fc3(x)
