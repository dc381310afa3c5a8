"""Mesh construction and sharding helpers, in PyTorch.

The port of ``pytorch3d_pointops_tpu/parallel/mesh.py``. One process drives
every device of a mesh, as JAX's single controller does:

* **Data parallelism (dp)**: the batch axis N of padded clouds splits over a
  mesh axis; every op is batch-parallel, so a batch shard needs nothing but
  its device.
* **Point parallelism (sp)**: the point axes split over a mesh axis and the
  reference clouds rotate around the ring (``parallel/ring.py``), the
  point-cloud analog of ring attention.

A ``Mesh`` is an n-d array of ``torch.device`` with one name per axis. A
device may appear more than once: ``make_mesh((4,), ("sp",),
devices=[torch.device("cuda", 0)] * 4)`` is four shards on one card, as the
JAX tests put eight virtual devices on one CPU.

A ``ProcessMesh`` (``multihost.process_mesh``) is the same grid with a
process at each entry, as JAX's ``make_mesh`` over ``jax.devices()`` spans
the processes of a multi-host job: each process holds and computes only
its own entry's blocks, on its own device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Devices in an n-d grid, one name per axis. ``shape`` maps each axis
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {devices.ndim} axes needs {devices.ndim} axis names "
                f"(got {axis_names})"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


class ProcessMesh:
    """Processes in an n-d grid, one name per axis: ``ranks`` holds the
    global rank at each entry, and this process computes on ``device``.
    Building one creates a ``torch.distributed`` group for every line of
    processes along every axis (each rank creates every group, in the same
    order, as ``new_group`` requires) and keeps the groups that hold this
    process."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: torch.device):
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {ranks.ndim} axes needs {ranks.ndim} axis names "
                f"(got {axis_names})"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.ranks = ranks
        self.axis_names = axis_names
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.coord = tuple(int(c) for c in np.argwhere(ranks == self.rank)[0])
        self._groups = {}
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = (group, [int(r) for r in line])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def line(self, axis: str) -> Tuple[object, List[int]]:
        """The group of the processes along ``axis`` through this one, and
        their global ranks in axis order."""
        return self._groups[axis]

    def position(self, axis: str) -> int:
        """This process's index along ``axis``."""
        return self.coord[self.axis_names.index(axis)]

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, ranks={self.ranks.tolist()}, "
                f"rank {self.rank} on {self.device})")


def comm_device(device: torch.device, group=None) -> torch.device:
    """Where the collectives of ``group`` (the default group when None)
    take their tensors: NCCL's on the card that ``device`` names, gloo's on
    the CPU (a process computing on a card stages through the host)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL group moves CUDA tensors (the process "
                             f"computes on {device})")
        return device
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"shards move over nccl or gloo, not {backend}")


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("dp", "sp"),
    devices=None,
) -> Mesh:
    """Build a Mesh over ``devices`` (default: every CUDA device).

    With no ``shape``, all devices go to the first axis. E.g.
    ``make_mesh((2, 4))`` -> 2-way dp x 4-way sp. Without CUDA, pass the
    devices (CPU devices, say): the default raises rather than fall back.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= to build a mesh "
                "of other devices"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} devices "
                         f"(got {len(devices)})")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def _block(size: int, parts: int, what: str) -> int:
    if size % parts:
        raise ValueError(f"{what} of size {size} does not split into {parts} shards")
    return size // parts


class ShardedTensor:
    """A tensor split over a mesh: ``pieces`` holds, for each mesh device
    (an object array of the mesh's shape), the block of the tensor that the
    device holds, on that device. ``full()`` puts it back together.

    On a ``ProcessMesh``, ``pieces`` is this process's block alone, on its
    device; ``shape`` is the global shape."""

    def __init__(self, pieces, sharding: "NamedSharding", shape):
        self.pieces = pieces
        self.sharding = sharding
        self.shape = torch.Size(shape)

    @property
    def local(self) -> torch.Tensor:
        """This process's block of a tensor on a ``ProcessMesh``."""
        if not isinstance(self.sharding.mesh, ProcessMesh):
            raise ValueError("local: the tensor is not on a process mesh")
        return self.pieces

    def full(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device, differentiable with
        respect to the pieces. On a ``ProcessMesh`` it is a collective: every
        process calls it, the blocks are all-gathered (not differentiable)
        and each process gets the whole tensor on its device."""
        mesh, spec = self.sharding.mesh, self.sharding.spec
        if isinstance(mesh, ProcessMesh):
            return self._gather_blocks()
        device = mesh.devices.flat[0]
        # One copy of each block: index 0 along every axis the spec replicates.
        piece = self.pieces
        for ax, name in reversed(list(enumerate(mesh.axis_names))):
            if name not in spec:
                piece = np.take(piece, 0, axis=ax)
        names = [n for n in mesh.axis_names if n in spec]

        def join(arr, axes):
            if not axes:
                return (arr.item() if isinstance(arr, np.ndarray) else arr).to(device)
            dim = spec.index(axes[0])
            return torch.cat([join(a, axes[1:]) for a in arr], dim=dim)

        return join(piece, names)

    def _gather_blocks(self) -> torch.Tensor:
        mesh, block = self.sharding.mesh, self.pieces.contiguous()
        comm = comm_device(mesh.device)
        parts = [torch.empty_like(block, device=comm)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, block.to(comm))
        out = torch.empty(self.shape, dtype=block.dtype, device=mesh.device)
        for coord in np.ndindex(*mesh.ranks.shape):
            out[self.sharding._slices(self.shape, coord)] = parts[mesh.ranks[coord]]
        return out


class NamedSharding:
    """A mesh and a spec: for each dimension of a tensor, the mesh axis it
    splits over, or None. ``shard(t)`` places the blocks."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]]):
        spec = tuple(spec)
        for name in spec:
            if name is not None and name not in mesh.axis_names:
                raise ValueError(f"spec axis {name!r} is not a mesh axis "
                                 f"{mesh.axis_names}")
        named = [n for n in spec if n is not None]
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec} splits two dimensions over one axis")
        self.mesh = mesh
        self.spec = spec

    def _slices(self, shape, coord) -> Tuple[slice, ...]:
        out = []
        for d, name in enumerate(self.spec):
            if name is None:
                out.append(slice(None))
                continue
            ax = self.mesh.axis_names.index(name)
            b = _block(shape[d], self.mesh.shape[name], f"dimension {d}")
            out.append(slice(coord[ax] * b, (coord[ax] + 1) * b))
        return tuple(out)

    def shard(self, t) -> ShardedTensor:
        """Split ``t`` (a tensor, or anything ``torch.as_tensor`` takes)
        into the mesh's blocks, each on its device. On a ``ProcessMesh``,
        where every process holds ``t``, each keeps its own block."""
        t = torch.as_tensor(t)
        if t.dim() != len(self.spec):
            raise ValueError(f"spec {self.spec} is for {len(self.spec)} dimensions "
                             f"(tensor has {t.dim()})")
        if isinstance(self.mesh, ProcessMesh):
            block = t[self._slices(t.shape, self.mesh.coord)]
            return ShardedTensor(block.to(self.mesh.device).contiguous(), self, t.shape)
        pieces = np.empty(self.mesh.devices.shape, dtype=object)
        for coord in np.ndindex(*self.mesh.devices.shape):
            pieces[coord] = t[self._slices(t.shape, coord)].to(self.mesh.devices[coord])
        return ShardedTensor(pieces, self, t.shape)


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding for (N, P, D) padded clouds: batch over ``axis``."""
    return NamedSharding(mesh, (axis, None, None))


def point_sharding(
    mesh: Mesh, point_axis: str = "sp", batch_axis: Optional[str] = None
) -> NamedSharding:
    """Sharding for (N, P, D) padded clouds: points over ``point_axis`` and
    optionally batch over ``batch_axis``."""
    return NamedSharding(mesh, (batch_axis, point_axis, None))


def shard_pointclouds(pc, mesh: Mesh, axis: str = "dp") -> List:
    """Split a ``Pointclouds`` batch over ``axis``: returns one
    ``Pointclouds`` for each mesh device, in mesh order (``mesh.devices``
    flattened), holding the clouds of that device's block of the batch, on
    that device. Devices that differ only along other axes hold the same
    clouds."""
    if axis not in mesh.axis_names:
        raise ValueError(f"{axis!r} is not a mesh axis {mesh.axis_names}")
    ax = mesh.axis_names.index(axis)
    b = _block(len(pc), mesh.devices.shape[ax], "the batch")
    return [
        pc[coord[ax] * b:(coord[ax] + 1) * b].to(mesh.devices[coord])
        for coord in np.ndindex(*mesh.devices.shape)
    ]
