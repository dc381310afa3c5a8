"""Ring-parallel KNN and chamfer over a device mesh, in PyTorch.

The port of ``pytorch3d_pointops_tpu/parallel/ring.py``. Query points p1
shard over a mesh axis while the reference clouds p2 rotate around the
ring, each position merging every visiting shard into a running top-K. The
merge sorts the concatenated candidates on (distance, global index), so the
result, exact ties included, does not depend on the order the shards visit
in. Returned indices are global p2 indices (the shard offset is added at
each hop), so the ring gives the single-device ops' results.

The hop loops run over the positions this process drives, and the ring
object says which those are and how a hop moves what travels:

* On a ``Mesh`` of this process's devices (``_Ring``), one process drives
  every position, as JAX's single controller does. An entry point pads P1
  and P2 to multiples of the ring size, splits whole tensors into shards on
  their mesh devices and moves each visiting shard, and the state that
  travels with it, to the next device with ``Tensor.to(device,
  non_blocking=True)``: a peer copy between cards, nothing on one card. So
  every update of a state is out of place: on one device the "sent" tensor
  is the object the neighbour holds. What ``point_sharding(mesh).shard``
  returned is first joined onto the mesh's first device.
* On a ``ProcessMesh`` (``_ProcessRing``), each process drives its own
  position alone and holds only its blocks: the inputs and outputs are
  blocks, every point axis divides by the ring size by construction, and a
  hop packs what travels into one buffer, sends it to the next rank and
  receives the previous rank's (``dist.batch_isend_irecv`` in the ring's
  group). The backend fixes the transport when the ring is built: NCCL
  sends the CUDA buffer, gloo a CPU one (staged through the host when the
  blocks are on a card). The chamfer's per-cloud and batch sums become
  sums across the ranks of the ring's and the batch's groups; neighbour
  features come through the ring gather.

Every hop runs the port's kernels, the CUDA kernel on CUDA shards and its
plain twin on CPU shards: ``kernels.knn.knn_topk`` (ring KNN),
``kernels.chamfer.chamfer_nn_bidirectional`` (ring chamfer) and, in every
backward hop, ``kernels.scatter.scatter_add_rows`` through
``ops.knn.knn_backward``. A backward is a second ring pass inside a
``torch.autograd.Function``: each (p2 shard, gradient accumulator) pair
travels the full cycle, every position adds the contributions of its own
queries whose neighbours fall in the visiting shard, and after ``n`` hops
the accumulator is home. Autograd does not see the hops, so on a process
mesh every process calls ``backward`` on the (replicated) loss.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import tracing
from ..kernels import chamfer as _chamfer_kernel
from ..kernels import knn as _knn_kernel
from ..kernels import scatter as _scatter
from ..ops.chamfer import (
    _LOCAL_SUMS,
    _apply_batch_reduction,
    _chamfer_distance_single_direction,
    _combine_directions,
    _LocalSums,
    _unpaired,
    _validate_chamfer_reduction_inputs,
)
from ..ops.knn import (
    _KNN,
    _all_pads,
    _apply_pad_conventions,
    _lengths,
    knn_backward,
    knn_gather,
)
from .mesh import Mesh, ProcessMesh, ShardedTensor, _block, comm_device

_INF = float("inf")


def _on(device: torch.device):
    """Make ``device`` current while a shard's kernels launch."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check_axes(names, point_axis: str, batch_axis: Optional[str]) -> None:
    if point_axis not in names:
        raise ValueError(f"point_axis {point_axis!r} is not a mesh axis {names}")
    if batch_axis is not None and (batch_axis not in names or batch_axis == point_axis):
        raise ValueError(f"batch_axis {batch_axis!r} must be another mesh "
                         f"axis than point_axis (mesh axes {names})")


def _ring_multiple(P: int, n: int) -> int:
    return -(-P // n) * n


class _Ring:
    """The rings of a mesh of this process's devices along ``point_axis``:
    one for each index along ``batch_axis`` (one ring when it is None), each
    the devices along ``point_axis`` with every other axis at its first
    index (the data is replicated along those axes, so one copy computes
    it). ``rows[g]`` lists the (position, device) pairs of ring ``g`` that
    this process drives: all of them. Entry points hand it whole tensors."""

    gather_fn = None  # neighbour features: knn_gather on the whole features

    def __init__(self, mesh: Mesh, point_axis: str, batch_axis: Optional[str]):
        names = mesh.axis_names
        _check_axes(names, point_axis, batch_axis)
        arr = mesh.devices
        for ax in reversed(range(len(names))):
            if names[ax] not in (point_axis, batch_axis):
                arr = np.take(arr, 0, axis=ax)
        if batch_axis is None:
            arr = arr.reshape(1, -1)
        elif names.index(batch_axis) > names.index(point_axis):
            arr = arr.T
        self.devices = [list(row) for row in arr]
        self.rows = [list(enumerate(row)) for row in self.devices]
        self.n = len(self.devices[0])

    # -- what an entry point sees --

    def blocks(self, t) -> torch.Tensor:
        """The whole tensor: a ``ShardedTensor`` is put back together."""
        return t.full() if isinstance(t, ShardedTensor) else torch.as_tensor(t)

    def lengths(self, lengths, N: int, P: int, device) -> torch.Tensor:
        return _lengths(lengths, N, P, device)

    def batch_block(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def check_blocks(self, *tensors) -> None:
        """Whole tensors need no check: the ring splits them itself."""

    def padded(self, P: int) -> int:
        """Points padded to a multiple of the ring size: the pad rows and
        columns are excluded by the lengths masks and trimmed from the
        outputs."""
        return _ring_multiple(P, self.n)

    def row_lengths(self, lengths: torch.Tensor, P: int) -> torch.Tensor:
        """``lengths`` for the rows an output holds: all of them."""
        return lengths

    def sums(self, P: int) -> _LocalSums:
        """The chamfer's reductions of a direction whose points are P."""
        return _LOCAL_SUMS

    # -- what the hop loops see --

    def shard_len(self, P: int) -> int:
        return P // self.n

    def _batch_len(self, N: int) -> int:
        return _block(N, len(self.devices), "the batch")

    def split(self, t: torch.Tensor):
        """Shards ``[g][j]`` of an (N, P, ...) tensor, ``j`` indexing
        ``rows[g]``: one block of the batch a ring, one block of the points
        a position, each contiguous on its device."""
        nb = self._batch_len(t.shape[0])
        pl = _block(t.shape[1], self.n, "the point axis")
        return [[t[g * nb:(g + 1) * nb, r * pl:(r + 1) * pl].to(dev).contiguous()
                 for r, dev in row]
                for g, row in enumerate(self.rows)]

    def split_batch(self, t: torch.Tensor):
        """The ring's block of an (N,) tensor, on each position's device."""
        nb = self._batch_len(t.shape[0])
        return [[t[g * nb:(g + 1) * nb].to(dev) for _, dev in row]
                for g, row in enumerate(self.rows)]

    def join(self, shards, device: torch.device) -> torch.Tensor:
        """The inverse of ``split``, on ``device``."""
        return torch.cat([torch.cat([s.to(device) for s in row], dim=1)
                          for row in shards], dim=0)

    def hop(self, g: int, *items):
        """Send what each position of ring ``g`` holds, in each list of
        ``items``, to the next one."""
        devs = self.devices[g]
        return [[it[r - 1].to(devs[r], non_blocking=True) for r in range(self.n)]
                for it in items]


class _ProcessRing(_Ring):
    """The ring of a ``ProcessMesh`` through this process: the processes
    along ``point_axis`` that share its other coordinates. It drives its own
    position alone, so ``rows`` is ``[[(position, device)]]``, and entry
    points hand it this process's blocks. A hop exchanges one packed buffer
    with the neighbours in the ring's group, over the transport that the
    group's backend fixes here, once."""

    def __init__(self, mesh: ProcessMesh, point_axis: str, batch_axis: Optional[str]):
        _check_axes(mesh.axis_names, point_axis, batch_axis)
        self.group, line = mesh.line(point_axis)
        self.n, self.pos = len(line), mesh.position(point_axis)
        self.next, self.prev = line[(self.pos + 1) % self.n], line[self.pos - 1]
        self.device = mesh.device
        self.rows = [[(self.pos, self.device)]]
        if batch_axis is None:
            self.batch_group, self.nb, self.bpos = None, 1, 0
        else:
            self.batch_group = mesh.line(batch_axis)[0]
            self.nb, self.bpos = mesh.shape[batch_axis], mesh.position(batch_axis)
        self.comm = comm_device(self.device, self.group)
        self.transport = dist.get_backend(self.group) + (
            ", staged through the host" if self.comm != self.device else "")
        self.gather_fn = functools.partial(_ring_gather, self)

    def blocks(self, t) -> torch.Tensor:
        """This process's block, on its device."""
        if isinstance(t, ShardedTensor):
            t = t.local
        return torch.as_tensor(t).to(self.device)

    def lengths(self, lengths, N: int, P: int, device) -> torch.Tensor:
        """Global (N,) lengths, the same on every process, as the lengths of
        this process's batch block; N and P are the block's."""
        if lengths is None:
            return torch.full((N,), P * self.n, dtype=torch.int64, device=device)
        return self.batch_block(_lengths(lengths, N * self.nb, P * self.n, device))

    def batch_block(self, t: torch.Tensor) -> torch.Tensor:
        """This process's block of a global (N,) tensor."""
        nb = _block(t.shape[0], self.nb, "the batch")
        return t[self.bpos * nb:(self.bpos + 1) * nb]

    def check_blocks(self, *tensors) -> None:
        """Raise, on every process of the ring, unless each tensor's batch
        and point sizes are the same on all of them: a hop exchanges
        buffers of one size, as JAX's ``NamedSharding`` splits a point axis
        that divides by the ring size."""
        sizes = torch.tensor([s for t in tensors for s in (t.shape[0], t.shape[1])],
                             device=self.device)
        hi = self.all_reduce(torch.cat([sizes, -sizes]), self.group, dist.ReduceOp.MAX)
        tracing.sync("ring.check_blocks")
        if not torch.equal(hi[:len(sizes)], -hi[len(sizes):]):
            raise ValueError(f"the blocks' (batch, points) sizes differ between the "
                             f"ring's processes: at most {hi[:len(sizes)].tolist()}, "
                             f"at least {(-hi[len(sizes):]).tolist()}")

    def padded(self, P: int) -> int:
        return P

    def row_lengths(self, lengths: torch.Tensor, P: int) -> torch.Tensor:
        return _local_lengths(lengths, self.pos * P, P)

    def sums(self, P: int) -> _LocalSums:
        return _RankSums(self, self.pos * P)

    def shard_len(self, P: int) -> int:
        return P

    def split(self, t: torch.Tensor):
        return [[t.to(self.device).contiguous()]]

    def split_batch(self, t: torch.Tensor):
        return [[t]]

    def join(self, shards, device: torch.device) -> torch.Tensor:
        return shards[0][0]

    def hop(self, g: int, *items):
        return [[t] for t in self.exchange([it[0] for it in items])]

    def exchange(self, tensors):
        """Send ``tensors`` to the next rank and return the previous rank's,
        of the same shapes and dtypes, in fresh tensors: one packed buffer
        each way, both in one ``batch_isend_irecv`` (for a ring of 2 the
        neighbours are one rank)."""
        if self.n == 1:
            return list(tensors)
        spans, total = [], 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            spans.append((total, nbytes))
            total += -(-nbytes // 8) * 8  # every span 8-byte aligned
        buf = torch.empty(total, dtype=torch.uint8, device=self.device)
        for t, (a, nbytes) in zip(tensors, spans):
            buf[a:a + nbytes] = t.contiguous().reshape(-1).view(torch.uint8)
        send = buf.to(self.comm)
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.next, self.group),
            dist.P2POp(dist.irecv, recv, self.prev, self.group),
        ]):
            req.wait()
        recv = recv.to(self.device)
        return [recv[a:a + nbytes].view(t.dtype).reshape(t.shape)
                for t, (a, nbytes) in zip(tensors, spans)]

    def all_reduce(self, t: torch.Tensor, group, op) -> torch.Tensor:
        """``t`` reduced across ``group``, in a fresh tensor on ``t``'s
        device."""
        out = t.detach().to(self.comm, copy=True)
        dist.all_reduce(out, op=op, group=group)
        return out.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """A sum across the ranks of ``group``. Every rank back-propagates the
    same replicated loss, so the gradient passes through unchanged
    (``torch.distributed.nn``'s all-reduce sums it again, multiplying every
    gradient by the number of ranks)."""

    @staticmethod
    def forward(ctx, t, ring: _ProcessRing, group):
        return ring.all_reduce(t, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllReduceAmax(torch.autograd.Function):
    """The maximum over dimension 1 across the ring's ranks, as ``amax``:
    the gradient is split evenly among every tied maximum on every rank."""

    @staticmethod
    def forward(ctx, t, ring: _ProcessRing):
        m = ring.all_reduce(t.amax(dim=1), ring.group, dist.ReduceOp.MAX)
        tied = t == m[:, None]
        count = ring.all_reduce(tied.sum(dim=1).to(t.dtype), ring.group,
                                dist.ReduceOp.SUM)
        ctx.save_for_backward(tied, count)
        return m

    @staticmethod
    def backward(ctx, grad):
        tied, count = ctx.saved_tensors
        return torch.where(tied, (grad / count)[:, None], 0.0), None


class _RankSums(_LocalSums):
    """The chamfer's reductions on a process ring: a direction's point sums
    and maxima across the ring's ranks, batch sums across the batch
    group's, the masks at this block's first global row."""

    def __init__(self, ring: _ProcessRing, first_row: int):
        self.ring, self.first_row, self.batch_parts = ring, first_row, ring.nb

    def points(self, t):
        return _AllReduceSum.apply(t.sum(dim=1), self.ring, self.ring.group)

    def points_max(self, t):
        return _AllReduceAmax.apply(t, self.ring)

    def batch(self, t):
        if self.ring.batch_group is None:
            return t.sum()
        return _AllReduceSum.apply(t.sum(), self.ring, self.ring.batch_group)


def _make_ring(mesh, point_axis: str, batch_axis: Optional[str]) -> _Ring:
    if isinstance(mesh, ProcessMesh):
        return _ProcessRing(mesh, point_axis, batch_axis)
    return _Ring(mesh, point_axis, batch_axis)


def _in_shard(idx, off: int, size: int):
    """Global ``idx`` as indices into the shard at ``off``: -1 outside it."""
    return torch.where((idx >= off) & (idx < off + size), idx - off, -1)


def _local_lengths(lengths, off: int, size: int):
    """Global lengths as the shard at ``off``'s own."""
    return (lengths - off).clamp(0, size)


def _merge_topk(sd, si, d, i, K: int):
    """The K smallest of two candidate sets by (distance, global index):
    a stable sort by index, then a stable sort by distance."""
    d = torch.cat([sd, d], dim=2)
    i, order = torch.sort(torch.cat([si, i], dim=2), dim=2, stable=True)
    d, order = torch.sort(torch.gather(d, 2, order), dim=2, stable=True)
    return d[..., :K], torch.gather(i, 2, order[..., :K])


def _merge_nn(d, i, d_new, i_new):
    """The nearer of two K=1 states, the lower global index on a tie."""
    better = (d_new < d) | ((d_new == d) & (i_new < i))
    return torch.where(better, d_new, d), torch.where(better, i_new, i)


# ----------------------------- ring KNN -----------------------------

def _ring_knn_fwd(ring: _Ring, p1, p2, lengths2, K: int, norm: int):
    xs, ys, l2s = ring.split(p1), ring.split(p2), ring.split_batch(lengths2)
    n, P2l = ring.n, ring.shard_len(p2.shape[1])
    out_d, out_i = [], []
    for g, row in enumerate(ring.rows):
        y = ys[g]
        sd = [torch.full((*x.shape[:2], K), _INF, device=x.device) for x in xs[g]]
        si = [torch.zeros((*x.shape[:2], K), dtype=torch.int64, device=x.device)
              for x in xs[g]]
        for t in range(n):
            for j, (r, dev) in enumerate(row):
                off = (r - t) % n * P2l
                with _on(dev):
                    len2 = _local_lengths(l2s[g][j], off, P2l)
                    d, i = _knn_kernel.knn_topk(xs[g][j], y[j], len2, K, norm)
                    sd[j], si[j] = _merge_topk(sd[j], si[j], d, i + off, K)
            if t < n - 1:
                (y,) = ring.hop(g, y)
        out_d.append(sd)
        out_i.append(si)
    return ring.join(out_d, p1.device), ring.join(out_i, p1.device)


def _ring_knn_bwd(ring: _Ring, p1, p2, lengths1, lengths2, idx, grad, norm):
    xs, ys = ring.split(p1), ring.split(p2)
    l1s, l2s = ring.split_batch(lengths1), ring.split_batch(lengths2)
    idxs, grads = ring.split(idx), ring.split(grad)
    n, P1l, P2l = ring.n, ring.shard_len(p1.shape[1]), ring.shard_len(p2.shape[1])
    gx_all, gy_all = [], []
    for g, row in enumerate(ring.rows):
        len1 = [_local_lengths(l1s[g][j], r * P1l, P1l) for j, (r, _) in enumerate(row)]
        y = ys[g]
        gy = [torch.zeros_like(s) for s in y]
        gx = [torch.zeros_like(s) for s in xs[g]]
        for t in range(n):
            for j, (r, dev) in enumerate(row):
                with _on(dev):
                    local = _in_shard(idxs[g][j], (r - t) % n * P2l, P2l)
                    a, b = knn_backward(xs[g][j], y[j], len1[j], l2s[g][j], local,
                                        norm, grads[g][j])
                    gx[j] = gx[j] + a
                    gy[j] = gy[j] + b
            if t < n - 1:
                gy, y = ring.hop(g, gy, y)
            else:
                (gy,) = ring.hop(g, gy)
        gx_all.append(gx)
        gy_all.append(gy)
    return ring.join(gx_all, p1.device), ring.join(gy_all, p2.device)


class _RingKnn(torch.autograd.Function):
    """Ring KNN on padded inputs, the pad conventions applied; the backward
    is the second ring pass."""

    @staticmethod
    def forward(ctx, p1, p2, lengths1, lengths2, ring, K, norm):
        # Without a pair of points or a slot, no hop (the blocks' sizes are
        # the same on every process, so every one skips).
        pads = _all_pads(p1, p2, K)
        if pads is None:
            d, i = _ring_knn_fwd(ring, p1, p2, lengths2, K, norm)
            d, i = _apply_pad_conventions(d, i, ring.row_lengths(lengths1, p1.shape[1]),
                                          lengths2, K, p1.shape[1])
        else:
            d, i = pads
        ctx.save_for_backward(p1, p2, lengths1, lengths2, i)
        ctx.ring, ctx.norm = ring, norm
        ctx.mark_non_differentiable(i)
        return d, i

    @staticmethod
    def backward(ctx, grad_dists, _grad_idx):
        p1, p2, lengths1, lengths2, idx = ctx.saved_tensors
        if p2.shape[1] * idx.numel() == 0:
            return (torch.zeros_like(p1), torch.zeros_like(p2), None, None, None,
                    None, None)
        gp1, gp2 = _ring_knn_bwd(ctx.ring, p1, p2, lengths1, lengths2, idx,
                                 grad_dists.to(torch.float32), ctx.norm)
        return gp1, gp2, None, None, None, None, None


def _pad_points(a, P: int):
    return F.pad(a, (0, 0, 0, P - a.shape[1])) if a.shape[1] != P else a


def ring_knn_points(
    p1,
    p2,
    lengths1: Optional[torch.Tensor] = None,
    lengths2: Optional[torch.Tensor] = None,
    norm: int = 2,
    K: int = 1,
    *,
    mesh: Mesh,
    point_axis: str = "sp",
    batch_axis: Optional[str] = None,
    return_nn: bool = False,
) -> _KNN:
    """KNN with p1 sharded over ``point_axis`` and p2 rotated around the ring.

    Semantics identical to ``ops.knn.knn_points`` (global indices, the
    reference's pad conventions). Differentiable with respect to p1 and p2
    through the backward ring pass.

    On a ``Mesh`` of this process's devices, ``p1`` and ``p2`` are tensors
    or what ``point_sharding(mesh).shard`` returned, and the outputs are
    whole tensors on ``p1``'s device. P1 and P2 that do not divide the ring
    size are padded inside (the pad rows and columns are excluded by the
    lengths masks and trimmed from the outputs), so any shape runs
    unmodified.

    On a ``ProcessMesh``, ``p1`` and ``p2`` are this process's blocks (or
    what ``multihost.host_local_to_global`` returned for them), the lengths
    are the global (N,) tensors, the same on every process, and the outputs
    (``dists``, ``idx`` with global indices, ``knn`` through the ring
    gather) are this process's blocks. Every process calls it, and
    ``backward``, with the same arguments.
    """
    ring = _make_ring(mesh, point_axis, batch_axis)
    p1, p2 = ring.blocks(p1), ring.blocks(p2)
    if p1.shape[0] != p2.shape[0]:
        raise ValueError("pts1 and pts2 must have the same batch dimension.")
    if p1.shape[2] != p2.shape[2]:
        raise ValueError("pts1 and pts2 must have the same point dimension.")
    if not (norm == 1 or norm == 2):
        raise ValueError("Support for 1 or 2 norm.")
    ring.check_blocks(p1, p2)

    p1 = p1.to(torch.float32)
    p2 = p2.to(torch.float32)
    N, P1, _ = p1.shape
    P2 = p2.shape[1]
    lengths1 = ring.lengths(lengths1, N, P1, p1.device)
    lengths2 = ring.lengths(lengths2, N, P2, p1.device)

    # Pad queries are zeroed by the lengths1 row mask and trimmed below; pad
    # candidates sit past every lengths2, so no hop admits them.
    p1p = _pad_points(p1, ring.padded(P1))
    p2p = _pad_points(p2, ring.padded(P2))
    dists, idx = _RingKnn.apply(p1p, p2p, lengths1, lengths2, ring, K, norm)
    dists, idx = dists[:, :P1], idx[:, :P1]
    nn = (ring.gather_fn or knn_gather)(p2, idx, lengths2) if return_nn else None
    return _KNN(dists=dists, idx=idx, knn=nn)


# ----------------------------- ring gather -----------------------------

def _ring_gather_fwd(ring: _Ring, values, idx):
    vs, idxs = ring.split(values), ring.split(idx)
    n, P2l = ring.n, ring.shard_len(values.shape[1])
    out = []
    for g, row in enumerate(ring.rows):
        y = vs[g]
        acc = [torch.zeros((*i.shape, values.shape[2]), dtype=values.dtype,
                           device=i.device) for i in idxs[g]]
        for t in range(n):
            for j, (r, _) in enumerate(row):
                local = _in_shard(idxs[g][j], (r - t) % n * P2l, P2l)
                N, L, K = local.shape
                rows = torch.gather(y[j], 1, local.clamp(min=0).reshape(N, L * K, 1)
                                    .expand(N, L * K, y[j].shape[2]))
                acc[j] = acc[j] + torch.where(local[..., None] >= 0,
                                              rows.reshape(N, L, K, -1), 0.0)
            if t < n - 1:
                (y,) = ring.hop(g, y)
        out.append(acc)
    return ring.join(out, values.device)


def _ring_gather_bwd(ring: _Ring, idx, grad, rows: int):
    idxs, grads = ring.split(idx), ring.split(grad)
    n, P2l = ring.n, ring.shard_len(rows)
    out = []
    for g, row in enumerate(ring.rows):
        gy = [torch.zeros((i.shape[0], P2l, grad.shape[-1]), device=i.device)
              for i in idxs[g]]
        for t in range(n):
            for j, (r, dev) in enumerate(row):
                with _on(dev):
                    N = idxs[g][j].shape[0]
                    local = _in_shard(idxs[g][j], (r - t) % n * P2l, P2l)
                    gy[j] = gy[j] + _scatter.scatter_add_rows(
                        local.reshape(N, -1),
                        grads[g][j].reshape(N, -1, grad.shape[-1]), P2l)
            (gy,) = ring.hop(g, gy)
        out.append(gy)
    return ring.join(out, grad.device)


class _RingGather(torch.autograd.Function):
    """Rows of ring-sharded values at global indices; the backward scatters
    into accumulators that ride the ring home."""

    @staticmethod
    def forward(ctx, values, idx, ring):
        ctx.save_for_backward(idx)
        ctx.ring, ctx.rows, ctx.dtype = ring, values.shape[1], values.dtype
        if ctx.rows * idx.numel() == 0:  # nothing to gather: no hop
            return values.new_zeros((*idx.shape, values.shape[2]))
        return _ring_gather_fwd(ring, values, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        if ctx.rows * idx.numel() == 0:
            return grad.new_zeros((idx.shape[0], ctx.rows, grad.shape[-1]),
                                  dtype=ctx.dtype), None, None
        gv = _ring_gather_bwd(ctx.ring, idx, grad.to(torch.float32), ctx.rows)
        return gv.to(ctx.dtype), None, None


def _ring_gather(ring: _Ring, x, idx, lengths):
    """The ring gather of ``x`` at ``idx``, zero-filled where ``k >=
    lengths[n]``: ``lengths`` as ``ring.lengths`` gives them."""
    K = idx.shape[2]
    gathered = _RingGather.apply(x, idx.to(torch.int64), ring)
    mask = torch.arange(K, device=x.device)[None, None, :] < lengths[:, None, None]
    return torch.where(mask[..., None], gathered, 0.0)


def ring_knn_gather(
    x,
    idx,
    lengths: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    point_axis: str = "sp",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """``knn_gather`` with values ``x`` (N, M, U) and indices (N, L, K) both
    sharded over ``point_axis`` (M and L multiples of its size): value
    shards rotate around the ring instead of being gathered whole.
    Differentiable with respect to ``x``; zero-fills entries where
    ``k >= lengths[n]`` exactly like ``ops.knn.knn_gather``. On a
    ``ProcessMesh`` ``x`` and ``idx`` are this process's blocks, ``lengths``
    the global (N,) tensor, and the result is this process's block."""
    ring = _make_ring(mesh, point_axis, batch_axis)
    x, idx = ring.blocks(x), ring.blocks(idx)
    ring.check_blocks(x, idx)
    N, M, _ = x.shape
    return _ring_gather(ring, x, idx, ring.lengths(lengths, N, M, x.device))


# ----------------------------- ring chamfer -----------------------------

def _ring_nn_fwd(ring: _Ring, x, y, x_lengths, y_lengths, norm: int):
    """One rotation serves both K=1 directions: each y shard travels with
    its own running (min, argmin) state, so every (x shard, y shard) pair
    meets once and one kernel launch gives the x -> y row minima and the
    visiting shard's y -> x column minima."""
    xs, ys = ring.split(x), ring.split(y)
    l1s, l2s = ring.split_batch(x_lengths), ring.split_batch(y_lengths)
    n, P1l, P2l = ring.n, ring.shard_len(x.shape[1]), ring.shard_len(y.shape[1])
    outs = ([], [], [], [])
    for g, row in enumerate(ring.rows):
        yv = ys[g]
        xd = [torch.full(s.shape[:2], _INF, device=s.device) for s in xs[g]]
        xi = [torch.zeros(s.shape[:2], dtype=torch.int64, device=s.device)
              for s in xs[g]]
        yd = [torch.full(s.shape[:2], _INF, device=s.device) for s in yv]
        yi = [torch.zeros(s.shape[:2], dtype=torch.int64, device=s.device) for s in yv]
        len1 = [_local_lengths(l1s[g][j], r * P1l, P1l) for j, (r, _) in enumerate(row)]
        for t in range(n):
            for j, (r, dev) in enumerate(row):
                off2 = (r - t) % n * P2l
                with _on(dev):
                    len2 = _local_lengths(l2s[g][j], off2, P2l)
                    d1, i1, d2, i2 = _chamfer_kernel.chamfer_nn_bidirectional(
                        xs[g][j], yv[j], len1[j], len2, norm)
                    xd[j], xi[j] = _merge_nn(xd[j], xi[j], d1, i1 + off2)
                    yd[j], yi[j] = _merge_nn(yd[j], yi[j], d2, i2 + r * P1l)
            if t < n - 1:
                yd, yi, yv = ring.hop(g, yd, yi, yv)
            else:
                yd, yi = ring.hop(g, yd, yi)
        for out, part in zip(outs, (xd, xi, yd, yi)):
            out.append(part)
    return (ring.join(outs[0], x.device), ring.join(outs[1], x.device),
            ring.join(outs[2], y.device), ring.join(outs[3], y.device))


def _ring_nn_bwd(ring: _Ring, x, y, x_lengths, y_lengths, i_xy, gd_xy, i_yx,
                 gd_yx, norm: int):
    """One backward rotation for both directions: the visiting tuple carries
    (y shard, its y -> x indices and gradients, its gradient accumulator);
    each hop adds the x -> y terms of local queries whose neighbour is in
    the visiting shard and the y -> x terms of visiting queries whose
    neighbour is in the local x shard."""
    xs, ys = ring.split(x), ring.split(y)
    l1s, l2s = ring.split_batch(x_lengths), ring.split_batch(y_lengths)
    ixy, gxy = ring.split(i_xy), ring.split(gd_xy)
    iyx, gyx = ring.split(i_yx), ring.split(gd_yx)
    n, P1l, P2l = ring.n, ring.shard_len(x.shape[1]), ring.shard_len(y.shape[1])
    gx_all, gy_all = [], []
    for g, row in enumerate(ring.rows):
        len1 = [_local_lengths(l1s[g][j], r * P1l, P1l) for j, (r, _) in enumerate(row)]
        yv, iy, gy = ys[g], iyx[g], gyx[g]
        acc = [torch.zeros_like(s) for s in yv]
        gx = [torch.zeros_like(s) for s in xs[g]]
        for t in range(n):
            for j, (r, dev) in enumerate(row):
                off1, off2 = r * P1l, (r - t) % n * P2l
                with _on(dev):
                    # x -> y: local queries whose neighbour is in the visiting
                    # shard; the K=1 KNN backward, whose k < lengths2 mask is
                    # the K=1 rule lengths2 > 0.
                    a, b = knn_backward(
                        xs[g][j], yv[j], len1[j], l2s[g][j],
                        _in_shard(ixy[g][j], off2, P2l)[..., None], norm,
                        gxy[g][j][..., None])
                    gx[j] = gx[j] + a
                    acc[j] = acc[j] + b
                    # y -> x: visiting queries whose neighbour is in the local shard.
                    a, b = knn_backward(
                        yv[j], xs[g][j], _local_lengths(l2s[g][j], off2, P2l),
                        l1s[g][j], _in_shard(iy[j], off1, P1l)[..., None], norm,
                        gy[j][..., None])
                    acc[j] = acc[j] + a
                    gx[j] = gx[j] + b
            if t < n - 1:
                acc, yv, iy, gy = ring.hop(g, acc, yv, iy, gy)
            else:
                (acc,) = ring.hop(g, acc)
        gx_all.append(gx)
        gy_all.append(acc)
    return ring.join(gx_all, x.device), ring.join(gy_all, y.device)


class _RingNNBidir(torch.autograd.Function):
    """Both chamfer K=1 directions from one ring rotation, with the pad
    conventions applied per direction. Returns (d_xy, i_xy, d_yx, i_yx)."""

    @staticmethod
    def forward(ctx, x, y, x_lengths, y_lengths, ring, norm):
        d1, i1, d2, i2 = _unpaired(x, y) or _ring_nn_fwd(ring, x, y, x_lengths,
                                                         y_lengths, norm)
        d1, i1 = _apply_pad_conventions(
            d1[..., None], i1[..., None], ring.row_lengths(x_lengths, x.shape[1]),
            y_lengths, 1, x.shape[1])
        d2, i2 = _apply_pad_conventions(
            d2[..., None], i2[..., None], ring.row_lengths(y_lengths, y.shape[1]),
            x_lengths, 1, y.shape[1])
        i1, i2 = i1[..., 0], i2[..., 0]
        ctx.save_for_backward(x, y, x_lengths, y_lengths, i1, i2)
        ctx.ring, ctx.norm = ring, norm
        ctx.mark_non_differentiable(i1, i2)
        return d1[..., 0], i1, d2[..., 0], i2

    @staticmethod
    def backward(ctx, gd1, _gi1, gd2, _gi2):
        x, y, x_lengths, y_lengths, i1, i2 = ctx.saved_tensors
        if x.shape[0] * x.shape[1] * y.shape[1] == 0:
            return torch.zeros_like(x), torch.zeros_like(y), None, None, None, None
        gx, gy = _ring_nn_bwd(ctx.ring, x, y, x_lengths, y_lengths, i1,
                              gd1.to(torch.float32), i2, gd2.to(torch.float32),
                              ctx.norm)
        return gx, gy, None, None, None, None


def ring_chamfer_distance(
    x,
    y,
    x_lengths: Optional[torch.Tensor] = None,
    y_lengths: Optional[torch.Tensor] = None,
    x_features: Optional[dict] = None,
    y_features: Optional[dict] = None,
    weights: Optional[torch.Tensor] = None,
    batch_reduction: Optional[str] = "mean",
    point_reduction: Optional[str] = "mean",
    norm: int = 2,
    single_directional: bool = False,
    abs_cosine: bool = True,
    feature_names: Optional[list] = None,
    *,
    mesh: Mesh,
    point_axis: str = "sp",
    batch_axis: Optional[str] = None,
):
    """Chamfer distance with both clouds sharded over the ring axis.

    One ring rotation serves both nearest-neighbour directions (the y shards
    travel with their running minima), and the reduction, feature and
    weights semantics are ``ops.chamfer``'s own code
    (``_chamfer_distance_single_direction``), so the ring can never drift
    from the single-device option matrix. ``single_directional`` runs the
    K=1 ring KNN instead.

    On a ``Mesh`` of this process's devices, the inputs are whole tensors
    (or what ``point_sharding(mesh).shard`` returned). Named feature
    channels fetch neighbour features with ``knn_gather``: the one process
    already holds the whole padded features on ``x``'s device, where the
    ring gather would take the same rows at the cost of n^2 gathers (and,
    for features that need gradients, n^2 scatters).

    On a ``ProcessMesh``, ``x``, ``y`` and the features are this process's
    blocks, ``x_lengths``, ``y_lengths`` and ``weights`` the global (N,)
    tensors, the same on every process. Neighbour features come through the
    ring gather; the per-cloud sums and maxima are taken across the ring's
    ranks and the batch sums across the batch axis's, so a reduced loss is
    the same on every process, and ``point_reduction=None`` terms (or
    per-cloud losses under ``batch_reduction=None``) are this process's
    blocks. Every process calls it, and ``backward`` on the loss, with the
    same arguments.

    Returns ``loss`` alone when no features are requested, else
    ``(loss, loss_features)``.
    """
    _validate_chamfer_reduction_inputs(batch_reduction, point_reduction)
    if not (norm == 1 or norm == 2):
        raise ValueError("Support for 1 or 2 norm.")
    return_features = (
        x_features is not None
        and y_features is not None
        and feature_names is not None
        and len(feature_names) > 0
    )
    if return_features and point_reduction == "max":
        raise ValueError('Features must be None if point_reduction is "max"')
    ring = _make_ring(mesh, point_axis, batch_axis)

    x = ring.blocks(x).to(torch.float32)
    y = ring.blocks(y).to(torch.float32)
    ring.check_blocks(x, y)
    N, P1, _ = x.shape
    P2 = y.shape[1]
    x_lengths = ring.lengths(x_lengths, N, P1, x.device)
    y_lengths = ring.lengths(y_lengths, N, P2, x.device)
    if weights is not None:
        weights = torch.as_tensor(weights, device=x.device)
        tracing.sync("ring.weights_sign")
        if bool((weights < 0).any()):
            # Checked on the global weights, so every process raises.
            raise ValueError("weights cannot be negative.")
        weights = ring.batch_block(weights)

    # Points and features padded to ring multiples up front; the lengths
    # masks exclude every pad row from losses, gathers and gradients.
    P1pad, P2pad = ring.padded(P1), ring.padded(P2)
    xp, yp = _pad_points(x, P1pad), _pad_points(y, P2pad)
    xf = yf = None
    if x_features is not None:
        xf = {k: _pad_points(ring.blocks(v), P1pad) for k, v in x_features.items()}
    if y_features is not None:
        yf = {k: _pad_points(ring.blocks(v), P2pad) for k, v in y_features.items()}

    if single_directional:
        # One direction needs no y -> x minima: the K=1 ring KNN skips the
        # y state's hops and the backward's y -> x terms.
        d1k, i1k = _RingKnn.apply(xp, yp, x_lengths, y_lengths, ring, 1, norm)
        d1, i1 = d1k[..., 0], i1k[..., 0]
    else:
        d1, i1, d2, i2 = _RingNNBidir.apply(xp, yp, x_lengths, y_lengths, ring, norm)

    sums_x = ring.sums(P1pad)
    cham_x, feats_x = _chamfer_distance_single_direction(
        xp, yp, x_lengths, y_lengths, xf, yf, weights, point_reduction,
        norm, abs_cosine, feature_names, nn=(d1, i1), gather_fn=ring.gather_fn,
        sums=sums_x,
    )
    if single_directional:
        loss, loss_features = cham_x, feats_x
    else:
        cham_y, feats_y = _chamfer_distance_single_direction(
            yp, xp, y_lengths, x_lengths, yf, xf, weights, point_reduction,
            norm, abs_cosine, feature_names, nn=(d2, i2), gather_fn=ring.gather_fn,
            sums=ring.sums(P2pad),
        )
        loss, loss_features = _combine_directions(
            cham_x, feats_x, cham_y, feats_y, point_reduction
        )

    if point_reduction is None:
        # Un-reduced terms keep the caller's point counts.
        if single_directional:
            loss = loss[:, :P1]
            if loss_features is not None:
                loss_features = {k: v[:, :P1] for k, v in loss_features.items()}
        else:
            loss = (loss[0][:, :P1], loss[1][:, :P2])
            if loss_features is not None:
                loss_features = {k: (v[0][:, :P1], v[1][:, :P2])
                                 for k, v in loss_features.items()}

    loss, loss_features = _apply_batch_reduction(
        loss, loss_features, weights, batch_reduction, sums=sums_x
    )
    if return_features:
        return loss, loss_features
    return loss
