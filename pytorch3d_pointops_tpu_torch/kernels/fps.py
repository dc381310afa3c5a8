"""Iterative farthest point sampling: the Hopper kernels ``csrc/fps.cu`` and
their plain PyTorch twin.

Four entry points, for the three TPU kernels of
``pytorch3d_pointops_tpu/kernels/fps_pallas.py``:

* ``fps_batched`` (``fps_pallas_batched``): one block per cloud, the cloud
  held on the SM (registers, and shared memory for the coordinates that
  registers do not hold) under a ``BlockPlan`` that ``_block_plan`` picks
  from P and D; for clouds up to ``fps_limits(...)[0]`` points;
* ``fps_clustered`` (also ``fps_pallas_batched``'s work, on clouds one
  block cannot hold): one thread-block cluster of 2 to 16 blocks per
  cloud, every cloud at once, each block holding a slice of its cloud as
  ``fps_batched``'s block holds a cloud, under a ``ClusterPlan`` that
  ``_cluster_plan`` picks from N, P and the clusters the card holds at once
  (``_cluster_card``); D=3, clouds up to ``cluster_limit(...)``;
* ``fps_resident`` (``fps_pallas``): every SM on one cloud at a time, the
  cloud held on chip (registers and shared memory) across the SMs; up to
  ``fps_limits(...)[1]``;
* ``fps_streaming`` (``fps_pallas_chunked``): every SM on one cloud, as
  much of it as fits on chip, the rest streamed from a copy in device
  memory every round; any size, any D.

The two grid entry points launch one kernel under a ``GridPlan`` that
``_grid_plan`` picks from the cloud size, D, the SM count and the shared
memory a block may take: its tier says where the min-distances (registers
or device memory) and the coordinates (registers, shared memory, or partly
streamed) live. Up to ``fps_limits(...)[1]`` points both entry points run
the same plan, and so the same kernel instance.

Each takes points (N, P, D) float32 and lengths, K, start indices (N,)
int64, and returns idx (N, max_K) int64: ``idx[n, 0]`` is the start, each
later slot the point farthest from those selected so far (on ties the
lowest index), -1 past ``min(K[n], lengths[n])``. Each runs where its
inputs are: CUDA tensors launch its kernel, CPU tensors take ``fps_plain``;
any other device raises. ``ops.fps`` picks the entry point by size. The
design note is at the top of ``csrc/fps.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build, tracing

_INF = float("inf")

GRID_THREADS = 1024   # threads of a grid block whose coordinates sit in shared memory
SLOTS = (8, 16, 32)   # min-distances such a thread may hold in registers
# At D=3, (threads, slots) of the blocks that hold their coordinates in
# registers too: slices of up to 8192 points.
REG_PLANS = ((256, 8), (512, 16))
MAX_GRID_BLOCKS = 256  # csrc/fps.cu kMaxGridBlocks
# (threads, slots) of the block kernel's instances (csrc/fps.cu
# launch_block_plan), by the most points each holds: at D=3 with
# coordinates in registers up to 8192 points, in shared memory beyond; at
# any other D in shared memory.
BLOCK_PLANS = {3: ((256, 8), (256, 16), (512, 16), (1024, 16)),
               0: ((1024, 8), (1024, 16), (1024, 32))}
_RECORD = 4           # 64-bit words a grid block publishes a round (kRecord)
_COPIES = 4           # copies of each record (kCopies)
# The cluster path (D=3): blocks a cluster; the (threads, 16 slots) of a
# block, each holding a slice of up to threads * 16 points (coordinates in
# registers up to 8192 points, in shared memory beyond); and its instances,
# each block shape under each cluster size, in the order of csrc/fps.cu
# FPS_CLUSTER_PLANS.
CLUSTERS = (2, 4, 8, 16)
CLUSTER_BLOCKS = ((256, 16), (512, 16), (1024, 16))
CLUSTER_PLANS = tuple((t, s, c) for t, s in CLUSTER_BLOCKS for c in CLUSTERS)


class BlockPlan(NamedTuple):
    """One launch of ``csrc/fps.cu``'s block kernel (``_block_plan``)."""

    threads: int     # a block, one block per cloud
    slots: int       # points a thread holds: threads * slots >= P
    smem_bytes: int  # dynamic shared memory: the coordinates registers do not hold


def _block_plan(P: int, D: int) -> BlockPlan:
    """The block kernel's launch for clouds of up to P points at dimension
    D: the first of ``BLOCK_PLANS`` that holds P, so the fewest slots for
    its thread count. At D=3 a plan of up to 8192 points keeps the
    coordinates in registers (no shared memory); otherwise they sit in
    shared memory as [d][q], rows of slots * threads points at D=3 and of P
    at any other D."""
    plans = BLOCK_PLANS[3 if D == 3 else 0]
    fit = [(t, s) for t, s in plans if t * s >= P]
    if not fit:
        raise ValueError(f"the FPS block kernel takes clouds of up to "
                         f"{plans[-1][0] * plans[-1][1]} points (got {P})")
    threads, slots = fit[0]
    in_regs = D == 3 and (D + 1) * slots * threads <= 32768  # csrc reg_coords
    smem = 0 if in_regs else 4 * D * (slots * threads if D == 3 else P)
    return BlockPlan(threads, slots, smem)


def block_plan_name(plan: BlockPlan) -> str:
    return (f"block t{plan.threads}/s{plan.slots} "
            f"{'smem' if plan.smem_bytes else 'registers'}")


class ClusterPlan(NamedTuple):
    """One launch of ``csrc/fps.cu``'s block kernel with a thread-block
    cluster per cloud (``_cluster_plan``)."""

    cluster: int     # blocks a cloud
    threads: int     # a block
    slots: int       # points a thread holds: threads * slots >= slice
    slice: int       # points of the largest cloud a block owns
    waves: int       # clusters in turn at one block an SM: ceil(N / clusters the card so holds)


def _cluster_plan(N: int, P: int, D: int, active: dict) -> ClusterPlan:
    """The cluster launch for N clouds of up to P points at D=3, where
    ``active`` maps each instance (threads, slots, cluster) of
    ``CLUSTER_PLANS`` to the clusters the card holds at once (0: none).

    For each cluster size C of ``CLUSTERS`` a block owns slice =
    ceil(P / C) points under the first of ``CLUSTER_BLOCKS`` that holds
    them, so the coordinates sit in registers up to 8192 points and in
    shared memory up to 16384 (the kernel passes over the ceil(slice /
    threads) slots a slice fills). Of the sizes the card runs, those that
    run the N clouds in the fewest waves at one block an SM remain (the
    clusters of 1,024-thread blocks the card holds at once: two smaller
    blocks on one SM share its issue), and of them the largest: a round
    costs about the same at every size but for the pass over a slice, which
    shrinks with it (``tune_fps.py --cluster``, PERF.md)."""
    if D != 3:
        raise ValueError(f"the FPS cluster path takes D=3 (got D={D})")
    fits = []
    for c in CLUSTERS:
        slice_ = -(-P // c)
        plan = next(((t, s) for t, s in CLUSTER_BLOCKS if t * s >= slice_), None)
        held = active.get((*plan, c), 0) if plan else 0
        if held > 0:
            spread = min(held, active.get((*CLUSTER_BLOCKS[-1], c), 0)) or held
            fits.append((c, *plan, slice_, -(-N // spread)))
    if not fits:
        raise ValueError(f"the FPS cluster path takes clouds of up to "
                         f"{_cluster_cap(active)} points on this card (got {P})")
    least = min(f[4] for f in fits)
    return ClusterPlan(*[f for f in fits if f[4] == least][-1])


def _cluster_cap(active: dict) -> int:
    """The most points a cloud may have on the cluster path: the largest
    cluster the card runs of the largest slice."""
    return max((t * s * c for (t, s, c), n in active.items() if n > 0), default=0)


def cluster_plan_name(plan: ClusterPlan) -> str:
    return (f"cluster {plan.cluster} x t{plan.threads}/s{plan.slots} slice {plan.slice} "
            f"waves {plan.waves}")


class GridPlan(NamedTuple):
    """One launch of ``csrc/fps.cu``'s grid kernel (``_grid_plan``)."""

    tier: str        # "resident", "registers" or "global"
    blocks: int      # one an SM
    threads: int     # a block
    slots: int       # min-distances a thread holds in registers; 0: none
    slice: int       # points of the largest cloud a block owns
    smem_slots: int  # slots of a slice whose coordinates sit in shared memory
    resident: int    # points of a slice whose coordinates stay on chip
    streamed: int    # the rest, read from a copy in device memory every round
    smem_bytes: int  # dynamic shared memory a block takes


def fps_plain(points, lengths, K, starts, max_K: int):
    """Plain PyTorch twin of the kernels, on any device: all clouds advance
    through each round together, distances summed axis by axis in order."""
    N, P, D = points.shape
    dev = points.device
    out = torch.full((N, max_K), -1, dtype=torch.int64, device=dev)
    if max_K == 0:
        return out
    valid = torch.arange(P, device=dev)[None, :] < lengths[:, None]
    k_n = torch.minimum(lengths, K)
    idx0 = torch.where(k_n > 0, starts, -1)
    out[:, 0] = idx0
    # Padded points sit at -1 and never win against a valid point (>= 0).
    min_d = torch.where(valid, _INF, -1.0).to(torch.float32)
    last = idx0.clamp(min=0)
    rows = torch.arange(N, device=dev)
    for i in range(1, max_K):
        sel = points[rows, last]  # (N, D)
        d2 = points.new_zeros((N, P))
        for d in range(D):
            diff = points[:, :, d] - sel[:, None, d]
            d2 = d2 + diff * diff
        min_d = torch.minimum(min_d, torch.where(valid, d2, -1.0))
        nxt = torch.argmax(min_d, dim=1)  # the first maximum
        active = i < k_n
        out[:, i] = torch.where(active, nxt, -1)
        last = torch.where(active, nxt, last)
    return out


def _check_inputs(points, lengths, K, starts, max_K):
    if points.dim() != 3:
        raise ValueError("points must be (N, P, D)")
    N = points.shape[0]
    for name, t in (("lengths", lengths), ("K", K), ("start_idxs", starts)):
        if t.shape != (N,):
            raise ValueError(f"{name} must be of shape (N,)")
    if not isinstance(max_K, int) or max_K < 0:
        raise ValueError(f"max_K must be a non-negative int (got {max_K!r})")


@functools.cache
def _lib():
    lib = _build.load("fps")
    lib.fps_card.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fps_block.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fps_grid.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p] * 5
    lib.fps_cluster.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fps_cluster_card.argtypes = [ctypes.c_void_p]
    for fn in (lib.fps_card, lib.fps_block, lib.fps_grid, lib.fps_cluster,
               lib.fps_cluster_card):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _card(device: int) -> tuple[int, int]:
    """(SM count, dynamic shared memory an FPS block may take) of CUDA
    device ``device``."""
    sms = ctypes.c_int()
    smem = ctypes.c_int()
    with torch.cuda.device(device):
        _build.check(_lib().fps_card(ctypes.byref(sms), ctypes.byref(smem)),
                     "fps_card")
    return sms.value, smem.value


@functools.lru_cache(maxsize=None)
def _cluster_card(device: int) -> dict:
    """{(threads, slots, cluster): clusters CUDA device ``device`` holds at
    once} for each instance of ``CLUSTER_PLANS``
    (``cudaOccupancyMaxActiveClusters``; 0 where it runs none)."""
    active = (ctypes.c_int * len(CLUSTER_PLANS))()
    with torch.cuda.device(device):
        _build.check(_lib().fps_cluster_card(active), "fps_cluster_card")
    return dict(zip(CLUSTER_PLANS, active))


def _smem_slots(D: int, smem_bytes: int, threads: int) -> int:
    """Slots of ``threads`` points whose D coordinates fit a grid block's
    shared memory, beside the selected point's D."""
    return max(0, (smem_bytes - 4 * D) // (4 * D * threads))


def _grid_caps(D: int, smem_bytes: int) -> tuple[int, int]:
    """(resident, registers): the most points a grid block's slice may have
    with every coordinate on chip and min-distances in registers (in
    registers up to 8192 points at D=3, in shared memory beyond), and the
    most with min-distances in registers at all (``GRID_THREADS`` x the
    largest of ``SLOTS``)."""
    registers = GRID_THREADS * SLOTS[-1]
    in_regs = (t * s for t, s in REG_PLANS
               if D == 3 and 4 * D * (t * s + 1) <= smem_bytes)
    on_chip = max(_smem_slots(D, smem_bytes, GRID_THREADS) * GRID_THREADS,
                  max(in_regs, default=0))
    return min(on_chip, registers), registers


def _grid_plan(N: int, P: int, D: int, sm_count: int, smem_bytes: int) -> GridPlan:
    """The launch of ``csrc/fps.cu``'s grid kernel for clouds of up to P
    points at dimension D: one block an SM, each owning ``slice`` =
    ceil(P / blocks) points of a cloud, S = ceil(slice / threads) slots a
    thread. The clouds take turns, so N does not change the plan.

    At D=3 a slice of up to 8192 points takes the first of ``REG_PLANS``
    that holds it (256 threads with 8 slots, or 512 with 16): each thread
    keeps its points' coordinates and min-distances in registers, and a
    copy of the coordinates in shared memory serves the candidates' lookups.
    Otherwise a block has ``GRID_THREADS`` threads, ``slots`` is the fewest
    of ``SLOTS`` that is at least S, or 0 past the largest, and the first
    slots' coordinates sit in shared memory (at D=3 all ``slots`` of them
    where they fit, so that the pass needs no branch between slots). The
    tier follows:

    * ``resident`` (slice <= the resident cap of ``_grid_caps``):
      min-distances in registers and every coordinate on chip;
    * ``registers`` (slice <= the register cap): min-distances in
      registers, the first slots' coordinates in shared memory, the rest
      streamed from a copy in device memory every round;
    * ``global``: as ``registers``, with min-distances in device memory."""
    if not 1 <= sm_count <= MAX_GRID_BLOCKS:
        raise ValueError(f"the FPS grid kernel takes 1 to {MAX_GRID_BLOCKS} SMs "
                         f"(got {sm_count})")
    slice_ = -(-P // sm_count)
    reg = [(t, s) for t, s in REG_PLANS
           if D == 3 and t * s >= slice_ and 4 * D * (t * s + 1) <= smem_bytes]
    if reg:
        (threads, slots), resident = reg[0], slice_
        smem_slots = -(-slice_ // threads)
    else:
        threads = GRID_THREADS
        S = -(-slice_ // threads)
        slots = next((s for s in SLOTS if s >= S), 0)
        fit = _smem_slots(D, smem_bytes, threads)
        # At D=3 all of a thread's slots in shared memory when they fit
        # (16): csrc/fps.cu then runs a pass without branches between slots.
        smem_slots = slots if D == 3 and 0 < slots <= fit else min(S, fit)
        resident = min(slice_, smem_slots * threads)
    streamed = slice_ - resident
    tier = "global" if not slots else "registers" if streamed else "resident"
    return GridPlan(tier, sm_count, threads, slots, slice_, smem_slots,
                    resident, streamed, 4 * D * (smem_slots * threads + 1))


def plan_name(plan: GridPlan) -> str:
    return (f"{plan.tier} t{plan.threads}/s{plan.slots} smem-slots {plan.smem_slots} "
            f"resident {plan.resident} streamed {plan.streamed}")


def fps_limits(D: int, device) -> tuple[int, int]:
    """(block, resident): the largest cloud ``ops.fps`` sends to
    ``fps_batched`` and the largest ``fps_resident`` takes at dimension D on
    this CUDA device, set by its shared memory per block and its number of
    SMs. The block cap is the (D + 1) * 4 bytes a point of a cloud held in
    shared memory (about 14.5k points at D=3, 29k at D=1); every
    ``_block_plan`` up to it holds the cloud on one SM."""
    device = torch.device(device)
    sms, smem = _card(device.index if device.index is not None
                      else torch.cuda.current_device())
    return smem // ((D + 1) * 4), sms * _grid_caps(D, smem)[0]


def cluster_limit(D: int, device) -> int:
    """The largest cloud ``fps_clustered`` takes at dimension D on this CUDA
    device: the largest cluster the card runs (at most 16 blocks) times the
    largest block slice (16,384 points at D=3); 0 at any other D."""
    if D != 3:
        return 0
    device = torch.device(device)
    return _cluster_cap(_cluster_card(device.index if device.index is not None
                                      else torch.cuda.current_device()))


def card_cluster_plan(points) -> ClusterPlan:
    """The plan ``fps_clustered`` launches for these CUDA points."""
    N, P, D = points.shape
    return _cluster_plan(N, P, D, _cluster_card(points.device.index))


def card_plan(points) -> GridPlan:
    """The plan the grid entry points launch for these CUDA points."""
    N, P, D = points.shape
    return _grid_plan(N, P, D, *_card(points.device.index))


def _launch(mode, points, lengths, K, starts, max_K, plan=None):
    """Launch ``csrc/fps.cu`` on CUDA tensors: float32 points, int64
    lengths/K/starts, all contiguous and on one device. The block mode
    takes ``plan`` or ``_block_plan``'s, the cluster mode ``plan`` or
    ``card_cluster_plan``'s, the grid modes ``plan`` or ``card_plan``'s."""
    _check_inputs(points, lengths, K, starts, max_K)
    for t, dtype in ((points, torch.float32), (lengths, torch.int64),
                     (K, torch.int64), (starts, torch.int64)):
        if not t.is_cuda or t.device != points.device:
            raise ValueError("the FPS kernels need every input on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"the FPS kernels need contiguous {dtype} inputs")
    N, P, D = points.shape
    dev = points.device
    out = torch.empty((N, max_K), dtype=torch.int64, device=dev)
    lib = _lib()
    args = (points.data_ptr(), lengths.data_ptr(), K.data_ptr(), starts.data_ptr(),
            N, P, D, max_K)
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        if mode == "block":
            plan = plan or _block_plan(P, D)
            err = lib.fps_block(*args, plan.threads, plan.slots, out.data_ptr(),
                                stream)
        elif mode == "cluster":
            plan = plan or card_cluster_plan(points)
            err = lib.fps_cluster(*args, plan.threads, plan.slots, plan.cluster,
                                  out.data_ptr(), stream)
        else:
            plan = plan or card_plan(points)
            if mode == "resident" and plan.tier != "resident":
                raise ValueError(
                    f"fps_resident takes clouds of up to {fps_limits(D, dev)[1]} "
                    f"points at D={D} (got {P})")
            S = -(-plan.slice // plan.threads)
            ctrl = torch.empty(2 + 2 * _COPIES * plan.blocks * _RECORD,
                               dtype=torch.int64, device=dev)
            soa = (torch.empty(plan.blocks * S * D * plan.threads,
                               dtype=torch.float32, device=dev)
                   if plan.streamed > 0 else None)
            min_d = (torch.empty(plan.blocks * S * plan.threads,
                                 dtype=torch.float32, device=dev)
                     if plan.slots == 0 else None)
            err = lib.fps_grid(*args, plan.blocks, plan.threads, plan.slots,
                               plan.smem_slots, ctrl.data_ptr(),
                               None if soa is None else soa.data_ptr(),
                               None if min_d is None else min_d.data_ptr(),
                               out.data_ptr(), stream)
    _build.check(err, f"fps ({mode})")
    return out


@tracing.spanned("fps")
def _dispatch(wrapper, mode, points, lengths, K, starts, max_K, plan=None):
    if points.is_cuda:
        out = _launch(mode, points, lengths, K, starts, max_K, plan)
        tracing.launch(wrapper)
        return out
    if points.device.type == "cpu":
        _check_inputs(points, lengths, K, starts, max_K)
        return fps_plain(points, lengths, K, starts, max_K)
    raise ValueError(f"fps: no kernel for device {points.device}")


def fps_batched(points, lengths, K, starts, max_K: int, *, _plan=None):
    """One block per cloud (clouds of up to ``fps_limits(D, dev)[0]``
    points). ``_plan`` forces a ``BlockPlan`` (``tune_fps.py``,
    ``chip_smoke.py``)."""
    return _dispatch("fps_batched", "block", points, lengths, K, starts, max_K,
                     _plan)


def fps_clustered(points, lengths, K, starts, max_K: int, *, _plan=None):
    """One thread-block cluster per cloud, every cloud at once (D=3, clouds
    of up to ``cluster_limit(3, dev)`` points). ``_plan`` forces a
    ``ClusterPlan`` (``tune_fps.py``, ``chip_smoke.py``)."""
    return _dispatch("fps_clustered", "cluster", points, lengths, K, starts, max_K,
                     _plan)


def fps_resident(points, lengths, K, starts, max_K: int, *, _plan=None):
    """Every SM on one cloud at a time, the cloud on chip (clouds of up to
    ``fps_limits(D, dev)[1]`` points). ``_plan`` forces a launch plan
    (``tune_fps.py``, ``chip_smoke.py``)."""
    return _dispatch("fps_resident", "resident", points, lengths, K, starts, max_K,
                     _plan)


def fps_streaming(points, lengths, K, starts, max_K: int, *, _plan=None):
    """Every SM on one cloud at a time, any size: what the chip cannot hold
    is streamed from device memory every round (``_grid_plan``'s tiers).
    ``_plan`` forces a launch plan (``tune_fps.py``, ``chip_smoke.py``)."""
    return _dispatch("fps_streaming", "streaming", points, lengths, K, starts, max_K,
                     _plan)
