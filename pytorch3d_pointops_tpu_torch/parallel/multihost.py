"""Multi-process initialization and cross-process sharding helpers.

The port of ``pytorch3d_pointops_tpu/parallel/multihost.py`` onto
``torch.distributed``: one process a host (or a card), joined in one process
group. Within a process, a mesh of its devices serves the ring layer
(``parallel/ring.py``); this module is the thin process-level entry point.

Typical use::

    from pytorch3d_pointops_tpu_torch.parallel import multihost, make_mesh
    multihost.initialize()          # once per process
    mesh = make_mesh((torch.cuda.device_count(),), ("sp",))
    # the global batch from each process's slab:
    x = multihost.host_local_to_global(x_local, mesh, ("dp", None, None))
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

logger = logging.getLogger("pytorch3d_pointops_tpu_torch.multihost")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the default process group (a no-op if one exists).

    ``coordinator_address`` is an ``init_method`` URL
    (``tcp://host:port``, ``file://...``); without arguments the group is
    read from the environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them). The backend is NCCL
    where CUDA is present, gloo otherwise. A failure of the argument-free
    call is logged as a warning and the process runs alone; with explicit
    arguments the failure is raised again, since a silent single-process
    fallback on a real cluster computes wrong results.
    """
    if dist.is_initialized():
        return
    explicit = any(
        a is not None for a in (coordinator_address, num_processes, process_id)
    )
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
    mesh: Mesh,
    spec: Sequence[Optional[str]],
) -> torch.Tensor:
    """The global tensor from every process's slab, on the mesh's first
    device.

    ``local_arr`` is this process's slab of the global tensor, concatenated
    along the first dimension that ``spec`` shards (the usual data-loader
    layout); slabs are gathered in rank order along that dimension. With
    one process the slab is the global tensor.
    """
    local = torch.as_tensor(local_arr)
    if local.dim() != len(spec):
        raise ValueError(f"spec {tuple(spec)} is for {len(spec)} dimensions "
                         f"(slab has {local.dim()})")
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
    ``spec``. With one process, the whole tensor."""
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
