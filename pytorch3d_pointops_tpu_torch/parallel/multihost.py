"""Multi-process initialization and cross-process sharding helpers.

The port of ``pytorch3d_pointops_tpu/parallel/multihost.py`` onto
``torch.distributed``: one process a host (or a card), joined in one process
group. A mesh may span the processes (``process_mesh``: one process a
card, each holding only its own blocks, the ring's hops sent between
them), or be a mesh of one process's own devices (``make_mesh``).

Typical use, one process a card (``torchrun --nproc_per_node=<cards>``)::

    from pytorch3d_pointops_tpu_torch.parallel import multihost, ring_chamfer_distance
    multihost.initialize()          # once per process
    mesh = multihost.process_mesh((dist.get_world_size(),), ("sp",))
    # this process's blocks of the global clouds, never gathered:
    x = multihost.host_local_to_global(x_block, mesh, (None, "sp", None))
    y = multihost.host_local_to_global(y_block, mesh, (None, "sp", None))
    loss = ring_chamfer_distance(x, y, x_lengths, y_lengths, mesh=mesh)
    loss.backward()                 # on every process

With a mesh of one process's devices, ``host_local_to_global`` gathers
every process's slab into the global tensor instead.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, NamedSharding, ProcessMesh, ShardedTensor

logger = logging.getLogger("pytorch3d_pointops_tpu_torch.multihost")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Initialize the default process group (a no-op if one exists).

    ``coordinator_address`` is an ``init_method`` URL
    (``tcp://host:port``, ``file://...``); without arguments the group is
    read from the environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them). The backend is
    ``backend``, else NCCL where CUDA is present and gloo otherwise (gloo
    with CUDA tensors stages the ring's hops through the host: several
    processes on one card, which NCCL refuses). A failure of the argument-free
    call is logged as a warning and the process runs alone; with explicit
    arguments the failure is raised again, since a silent single-process
    fallback on a real cluster computes wrong results.
    """
    if dist.is_initialized():
        return
    explicit = any(
        a is not None for a in (coordinator_address, num_processes, process_id)
    )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise
        # Visible by default: on a real cluster a swallowed failure means
        # every process silently computes single-process results.
        logger.warning(
            "torch.distributed auto-detection failed (%s); proceeding "
            "single-process. If this is a multi-process run, pass "
            "coordinator_address/num_processes/process_id explicitly.",
            e,
        )
        return
    logger.info("process group initialized: rank %d of %d", dist.get_rank(),
                dist.get_world_size())


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    device: Optional[torch.device] = None,
) -> ProcessMesh:
    """A mesh whose entries are the processes of the default group, laid
    out rank-major as JAX's ``make_mesh((jax.process_count(),
    jax.local_device_count()), ...)`` is. Every process calls it, with the
    same arguments, after :func:`initialize`. Each process computes on
    ``device``, by default its own card ``cuda:LOCAL_RANK`` (made current);
    without CUDA pass the device (the CPU, say): the default raises rather
    than fall back."""
    if not dist.is_initialized():
        raise RuntimeError("process_mesh: call multihost.initialize() first")
    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"process mesh shape {shape} needs {int(np.prod(shape))} "
                         f"processes (the group has {world})")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("process_mesh: no CUDA device; pass device= to "
                               "compute on another device")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return ProcessMesh(np.arange(world).reshape(shape), axis_names, device)


def _first_sharded_dim(mesh: Mesh, spec: Sequence[Optional[str]]) -> int:
    for d, name in enumerate(spec):
        if name is not None:
            if name not in mesh.axis_names:
                raise ValueError(f"spec axis {name!r} is not a mesh axis "
                                 f"{mesh.axis_names}")
            return d
    raise ValueError(f"spec {tuple(spec)} shards no dimension")


def host_local_to_global(
    local_arr,
    mesh,
    spec: Sequence[Optional[str]],
):
    """The global tensor from every process's slab.

    On a ``ProcessMesh``, ``local_arr`` is this process's block (its entry's
    block of every dimension that ``spec`` shards) and the result is a
    ``ShardedTensor`` that holds that block alone, on the process's device,
    with the global shape recorded: nothing is gathered.

    On a ``Mesh`` of one process's devices, the result is the whole tensor
    on the mesh's first device: ``local_arr`` is this process's slab of the global tensor, concatenated
    along the first dimension that ``spec`` shards (the usual data-loader
    layout); slabs are gathered in rank order along that dimension. With
    one process the slab is the global tensor.
    """
    local = torch.as_tensor(local_arr)
    if local.dim() != len(spec):
        raise ValueError(f"spec {tuple(spec)} is for {len(spec)} dimensions "
                         f"(slab has {local.dim()})")
    if isinstance(mesh, ProcessMesh):
        sharding = NamedSharding(mesh, spec)
        shape = [s * (mesh.shape[name] if name is not None else 1)
                 for s, name in zip(local.shape, spec)]
        return ShardedTensor(local.to(mesh.device).contiguous(), sharding, shape)
    dim = _first_sharded_dim(mesh, spec)
    device = mesh.devices.flat[0]
    rank, world = _world()
    if world == 1:
        return local.to(device)
    # NCCL gathers CUDA tensors, gloo CPU ones.
    comm = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend() == "nccl") else torch.device("cpu")
    local = local.to(comm).contiguous()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    return torch.cat(parts, dim=dim).to(device)


def global_to_host_local(
    global_arr,
    spec: Optional[Sequence[Optional[str]]] = None,
) -> torch.Tensor:
    """This process's slab of a global tensor: its block, in rank order, of
    the first dimension that ``spec`` shards (dimension 0 without a
    ``spec``), the inverse of :func:`host_local_to_global` with the same
    ``spec``. With one process, the whole tensor. A ``ShardedTensor`` on a
    ``ProcessMesh`` gives back the block it holds."""
    if isinstance(global_arr, ShardedTensor) and isinstance(
            global_arr.sharding.mesh, ProcessMesh):
        return global_arr.local
    g = torch.as_tensor(global_arr)
    dim = 0
    if spec is not None:
        dim = next((d for d, name in enumerate(spec) if name is not None), None)
        if dim is None:
            raise ValueError(f"spec {tuple(spec)} shards no dimension")
    rank, world = _world()
    if g.shape[dim] % world:
        raise ValueError(f"a dimension {dim} of {g.shape[dim]} does not split into "
                         f"{world} processes")
    return torch.chunk(g, world, dim=dim)[rank]
