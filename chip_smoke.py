#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (pytorch3d_pointops_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0]

Phase 1 builds the CUDA kernels from ``pytorch3d_pointops_tpu_torch/csrc``
(five sources, one ``nvcc`` each, in parallel) into ``build/``, prints the
registers and spills of every KNN, chamfer NN, FPS and ball query kernel
instance (and fails if one at D=3 spills), and prints the card's name and
power limit.
Phase 2 holds every kernel against its plain PyTorch twin on the card:
ragged lengths, fully masked clouds, norms 1 and 2, D in {3, 16}, K in {1,
8, 16, 64, 100} (KNN, distances bit-equal, under the default launch plan
and, at sizes that are no multiple of a block, tile or group, under every
plan; then a 20,000 x 20,000 cloud with distance-0 ties under every plan)
and {1, 32, 100, 500} (ball query), points on a 1/8 grid so that ties and
ball boundaries are real, the ball query at the edges of its warp per
query (lengths2 of 31, 32, 33 and one past a staged tile, 37 queries, K in
{1, 31, 32, 33, 500}, clouds whose points all coincide, D in {3, 5, 16}),
the chamfer NN kernel's D=3 instance at every
pair of sizes in {1, 127, 129, 1,023, 1,025, 2,049} with lengths of 0, 1
and mid-sub-tile on grid clouds and clouds with duplicated points
(distances and indices equal), and its sub-tile rescan on grid clouds of
1,100 x 2,300 points and at the chamfer cell's 32 x 16,384 (all four
outputs equal, both norms, the launches and ``chamfer.rescan_points``
counted), every FPS entry point with per-cloud K (K past the length and past the
number of distinct points), explicit starts and an empty cloud, the FPS
block kernel under every block plan at each plan's capacity - 1, + 0 and
+ 1 up to the block cap and at the cap (D = 3, 16 and 1; lengths 0, 1 and
17), the FPS grid kernel at and around each capacity of its launch plan
(the largest slice with coordinates in registers, resident and register
caps +- 1, 6M points, D=16 and D=1 past their caps), and the
scatter: both entry points under the plan ``scatter_plan`` picks (the bucket kernel alone, a one- and
a two-pass partition; 2 to 33 channels) on uniform targets, on targets
that crowd 16 rows and on targets all on one row, run twice and compared
bit for bit with each other and with the plain twin on CPU copies, then a
skewed input under every bucket size; and every kernel at the Point
Transformer cell's shapes (``pt_kernels``; the model at published widths
on four generated rooms of 80,000, 80,000, 74,213 and 61,857 points): each
FPS of its plan (K = L // 4 of each ragged cloud; the grid kernel at 80k
and 20k points a cloud, the block kernel below) under every entry point
that takes it, every KNN (self at K = 8 and 16, each ``TransitionDown``'s at
16, each ``TransitionUp``'s at 3; ragged cross-level batches), the scatter
at C = 64 into 296,070 rows (2.37M entries) and C = 1,024 into 1,154 rows
and the gathers' backward through ``masked_gather`` and ``knn_gather``
there, each against its twin. Phase 3
drives two main paths at
full size through the public entry points, each with every launch counter
set to 0 just before and read just after:

* config 3: ``chamfer_distance`` on two ``Pointclouds`` of 16 x 10,000
  points (ragged 9,000-10,000) with normals and colors, mean/mean, five SGD
  steps of forward and backward; config 1: ``knn_points`` on 2 clouds of
  1000/800 points, K=8; north star: ``knn_points`` on 100k x 100k points,
  K=16; both forward and backward (the KNN launch plans are printed);
* config 2 (PointNet++ grouping): ``sample_farthest_points`` (K=512) then
  ``ball_query`` (K=32, r=0.2) on 32 clouds of up to 4,096 points (ragged
  3,500-4,096, uniform in the unit ball), and a loss on the grouped local
  coordinates and distances backward into the points, five steps; then
  ``sample_farthest_points`` on one cloud of 1,000,000 points (K=1024) and
  one of 4,000,000 points (K=512), which route to the two grid FPS kernels.

It then checks each path against the plain path on the card (config 3 and
config 2 losses within rel 1e-5, gradients within 1e-5 of their largest
entry, FPS and ball indices equal; the north-star KNN on a 4,096-query
subset; the large-cloud FPS indices), two backward runs for bit-equality,
and times every kernel at the main path's shapes beside its plain twin, its
bound and, for the scatter, ``index_add_``. Each timed launch is also held
against its plain twin at that shape (indices equal, values within 1e-5;
chamfer NN distances equal, in both norms)
and the scatters run twice for bit-equality and against the plain twin on
CPU copies, with ``index_add_`` timed non-deterministic and deterministic;
each scatter's launches are timed apart (CUDA events between them) and
its device operations counted in a CUDA graph of one call, one for each
step of its plan (at most 4; 1 for one config 1 cloud, whose rows fit one
bucket), as are config 2's three backward scatters and
config 1's, a skewed scatter (one row of 100,000 of 200,000 entries) and
one with every entry on one row through
both entry points, and the K=1 scatters of a config 3 step with its source
collapsed to a point beside the normal step's, each with its longest row;
the FPS grid round's fixed cost is timed on a cloud of 8 points a block,
the block round's on 32 clouds of 512 points.

Phase 3c drives the Point Transformer's training step (``plan``, forward,
cross-entropy, backward) on phase 2's rooms as a main path with its own
launch counts (2 grid and 2 block FPS launches, 26 scatters, at least one
KNN launch for each of its 13 KNN calls, no other kernel) under
``torch.cuda.set_sync_debug_mode("error")`` with no ``sync.`` counter, and
prints its peak memory and its step time. Two steps are bit-equal, and
so is the step through the plain twins on the card with the scatter's twin
on CPU copies: the plan's indices and distances, the logits, the loss and
every gradient.

Phase 4 holds the KNN kernel's query sorting (``sort_queries``) bit-equal
to the unsorted kernel in both norms at the north star (K=16, 100), config
1, the 20k tie cloud, a ragged batch of 3 clouds (lengths2 0, 1 and P2 - 1,
garbage past them, a box per cloud) and a cloud whose every point appears
twice, and equal to the plain twin but at the north star; prints the
kernel's counters (groups, fired votes, drains, insertions,
pending appends) at the north star, unsorted and sorted, and the sorted
times; drives config 4 (1M x 1M KNN, K=16, fwd+bwd through
``knn_points``) as a main path with its own launch counts, auto-sorted
against unsorted, the step against the plain path on the card (every
query's indices and distances, both gradients), the backward's 16M-entry
scatter against the plain twin (bit-equal on CPU copies), with the
forward, backward and scatter times, the scatter's launch by launch; and
runs ``packed_to_padded``, ``padded_to_packed`` (with gradients) and ``sample_pdf`` on the card
against CPU tensors.

Phase 5 checks the KNN kernel's kth-bound seeding: the north-star
``knn_points`` step at K=100 (seeded by default: the sample pass, the
screen's candidate order, the screen and the select with the queries
sorted, two gated repair launches that return at once, the backward's
scatter) as a main path with its own
launch counts, its forward under ``torch.cuda.set_sync_debug_mode("error")``,
against the plain path on the card (every query's indices and distances,
both gradients); seeded calls bit-equal to unseeded ones at the north star
(K=100 in both norms, K=16 and K=64 opted in), on the 20k tie cloud, the
duplicated cloud and the ragged batch (bounds off for its lengths 0 and 1),
the queries sorted and not, all without a host sync; the screen's skip
(``screen5``: its order equal to the plain twin, counts equal to the full
scan's, the scanned share, a forced short last chunk, a P2 = 16,384,
K = 1,000 call timed with and without it); bounds of -1 forcing the repair
(its gate word 1, five launches, the result exact); a raw ``ub=`` round
bit-equal to the plain twin, sentinel slots included; the counters'
insertions with and without a seed at K=16 and 64; and seeded against
unseeded times.

Phase 6 drives the ring layer (``pytorch3d_pointops_tpu_torch.parallel``)
over a ``("sp",)`` mesh of four shards on ``cuda:0`` as a main path with
its own launch counts: ``ring_chamfer_distance`` at config 5's cloud width
(16 clouds of 100,000 points, ragged 90,000-100,000, normals and colors,
mean/mean, five SGD steps; cut from 256 clouds on two or more hosts for one
card and the script's run time), then ``ring_knn_points`` at the north
star, K=16 fwd+bwd and K=100 fwd. It requires 4 x 4 hops of the chamfer NN
kernel a forward and of the KNN kernel at K=16, and the backward's rows
scatters. Each shape is held against the single-card op on the same inputs
(losses within rel 1e-5, both NN index sets equal, KNN distances
bit-equal, gradients within 1e-5 of their largest entry, two ring
backwards bit-equal) and against the same ring call through the plain
twins (indices equal; distances, losses and gradients within 1e-5; the
single-card chamfer NN against its plain twin too). So are the edges
(lengths that leave whole shards empty: 0, 1 and P - 1; shards of 10
points at K=16; both kernels' raw (inf, 0) output on such shards, which is
also held against the plain twins) and config 3 over a 2 x 2 ``("dp",
"sp")`` mesh. It prints the ring's wall time beside the single card's for
each shape, and one hop's kernel time at the shard shape.

Phase 7 runs the ring across processes: four workers, spawned after the
build, each one position of a ``("sp",)`` process mesh
(``multihost.process_mesh``) and of a 2 x 2 ``("dp", "sp")`` one, all on
``cuda:0``. NCCL refuses two ranks on one card ("Duplicate GPU
detected"), so the group is gloo and every hop is staged through the host;
the kernels run on the card. Each worker drives the main path on its own
blocks with its own launch counts (config 5's ring chamfer, five SGD
steps; the north-star ring KNN at K=16 fwd+bwd and K=100 fwd), then the
edges and config 3 on the 2 x 2 mesh, and holds every output and gradient
block against phase 6's one-process ring on the same inputs (indices
equal, distances bit-equal, losses within rel 1e-5, gradients within 1e-5
of the largest entry; the losses equal on every rank). It prints the
transport, each rank's launches, the step's wall ms (the maximum over
ranks) beside phase 6's and one hop's transfer ms: four processes sharing
one card, hops through the host, the protocol's cost and not a scaling
figure. A failed worker or check, or workers still running after 300 s,
fails the script.

Phase 8 runs the port's eight examples (``pytorch3d_pointops_tpu_torch/
examples``) on the card, each ``main(device="cuda")`` with every launch
counter set to 0 just before and read just after, and requires each to
launch the kernels it runs (``EXAMPLE_KERNELS``); their own prints go to
``build/chip_smoke_examples.log``. ``knn_and_chamfer``,
``fps_and_ball_query``, ``covariances_demo`` and ``ring_parallel`` run
again inside ``plain_path()``: indices equal, values within 1e-5 of their
largest entry, and the outputs of the 100- and 50-step SGD loops within
1e-4 (rounding drifts apart over the steps). ``performance`` holds each
kernel it times against its plain twin on the same card tensors at every
size (KNN K=16 up to P = 50,000, ball query and FPS up to 20,000, the last
on the grid kernel): indices equal, values within 1e-5 of their largest
entry. Its figures are printed beside the card's name and power limit, and
its ``knn_points`` (K=32) call at P = 50,000 must peak under 1 GB.

Phase 9 runs ``sweep.py``'s first 200 seeded cases (every kernel's public
route at small shapes: ragged lengths with 0, K up to P2 + 7, grid and
duplicated clouds, D in {1, 2, 3, 5}, both norms, the chamfer option
matrix) on CUDA tensors against the plain twins on CPU copies (indices
equal, values within 1e-5, gradients within 1e-5 of their largest entry)
and against the port's host library (``native.py``, built from
``csrc/pointops_cpu.cpp`` with ``g++``); a failure names the case's seed,
shapes and parameters.

Phase 10, after every other phase (a device-side assert would poison the
context for whatever ran after it), runs ``sweep.empty_cases()``: empty
dimensions (N, P1, P2 or P = 0), K = 0, the chamfer option matrix with an
empty y cloud and every length 0 with P > 0, through the public ops on
CUDA tensors against the same calls on CPU tensors (shapes, indices,
values within 1e-5, NaN where NaN; where the JAX package refuses, both
devices raise on the host, never a CUDA error). A case with an axis at 0
must launch no kernel. Then the KNN, chamfer NN and ball query entry
points are called directly at P2 = 0 and the rows scatter with no entry
and into no row, each equal to its plain twin. It prints its wall time
and the cases that launched each kernel.

The line before the last is one JSON object with a record per kernel
(every record carries ``examples_launches``, its launches over phase 8,
``sweep_cases``, the phase 9 cases that launched it, and ``empty_cases``,
the phase 10 cases that did; the three kernels
the rings run also carry ``ring_launches`` and rank 0's
``procs_launches``); the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero without that line.
Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

TOL = 1e-5  # values and gradients; indices must match exactly


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# The kernel wrappers, by the names of their launch counters
# (``tracing``'s ``launch.<wrapper>``).
WRAPPERS = ("knn_topk_cuda", "chamfer_nn_cuda", "scatter_add_rows", "scatter_add_k1",
            "ball_query_cuda", "fps_batched", "fps_clustered", "fps_resident",
            "fps_streaming")


def reset_launches() -> None:
    """Every counter of the port's ``tracing`` back to 0, the launch
    counters among them."""
    from pytorch3d_pointops_tpu_torch import tracing

    tracing.clear()


def launch_counts(wrappers) -> dict:
    """Each wrapper's launches since the last ``reset_launches()``."""
    from pytorch3d_pointops_tpu_torch import tracing

    got = tracing.counts("launch.")
    return {w: got.get("launch." + w, 0) for w in wrappers}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median host time in ms of ``fn`` ended by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def recorded_scatters():
    """Records the (idx, contrib, P2) of every scatter launched inside."""
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    calls = []
    launch = ks._launch

    def recording(idx, contrib, P2, events=None, plan=None):
        calls.append((idx, contrib, P2))
        return launch(idx, contrib, P2, events, plan)

    ks._launch = recording
    try:
        yield calls
    finally:
        ks._launch = launch


def hold_scatter(wrapper, idx, contrib, P2, what):
    """One scatter entry point on the card, bit-equal from run to run and to
    the plain twin on CPU copies (which sums each row in entry order, as
    the kernels do); returns its output."""
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    out = wrapper(idx, contrib, P2)
    require(torch.equal(out, wrapper(idx, contrib, P2)),
            f"{what}: not bit-equal run to run")
    require(torch.equal(out.cpu(), ks.scatter_add_plain(idx.cpu(), contrib.cpu(), P2)),
            f"{what}: not bit-equal to the CPU twin")
    return out


def scatter_line(idx, contrib, P2, reps=10):
    """A scatter's time (CUDA events, median of ``reps``), its steps' times
    (``launch_steps``) and its longest row, as one line of text, and the
    steps. The steps must be the device operations that one call of
    ``scatter_add_rows`` enqueues, as a CUDA graph captures them
    (``device_ops``): the zeroing a memset, every other step a kernel."""
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.tune_scatter import device_ops, launch_steps

    N, E, C = contrib.shape
    rows = (idx + torch.arange(N, device=idx.device)[:, None] * P2)[idx >= 0]
    longest = int(torch.bincount(rows).max()) if rows.numel() else 0
    ms = cuda_ms(lambda: ks.scatter_add_rows(idx, contrib, P2), reps=reps)
    steps = launch_steps(idx, contrib, P2, reps=reps)
    ops = device_ops(lambda: ks.scatter_add_rows(idx, contrib, P2))
    expected = ["memset" if step == "zero" else "kernel" for step in steps]
    require(sorted(ops) == sorted(expected),
            f"scatter {N} x {E} into {P2}: the call enqueued {ops}, its steps "
            f"{list(steps)}")
    return (f"{N} x {E} entries ({int((idx < 0).sum())} skipped, longest row "
            f"{longest}) into {P2} rows x {C}: {ms:.4f} ms, {len(ops)} device "
            f"operations ({', '.join(ops)}; a CUDA graph of one call), per launch (ms) "
            f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}"), steps


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_points(rng, shape):
    """Coordinates on a 1/8 grid over [-0.5, 0.5]: many exact duplicates."""
    return rng.integers(-4, 5, size=shape).astype(np.float32) / 8.0


def kernel_instances(log: str, kernel: str) -> dict:
    """{template arguments: (registers, spill store bytes)} of each instance
    of ``kernel`` in ``nvcc -Xptxas -v`` output; the arguments are ints
    (a bool as 0 or 1) in template order."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?" + kernel + r"I((?:L[ib]-?\d+E)+)E",
                      ln)
        if m:
            key = tuple(int(g) for g in re.findall(r"L[ib](-?\d+)E", m.group(1)))
            out[key] = [0, 0]
        elif key and "bytes spill stores" in ln:
            out[key][1] = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif key and "Used" in ln and "registers" in ln:
            out[key][0] = int(ln.split("Used")[1].split()[0])
            key = None
    return {k: tuple(v) for k, v in out.items()}


def phase4(args, T, ns_p1, ns_p2, pc1, pc2, tie1, tie2, knn_step, plain_path,
           note_err):
    """Query sorting held against the unsorted kernel (and the plain twin
    at the smaller shapes), the kernel's counters unsorted and sorted at the
    north star, config 4 (1M x 1M KNN) as a main path held against the
    plain path, and packed/padded and sample_pdf on the card against the
    same calls on CPU tensors."""
    import pytorch3d_pointops_tpu_torch as ppt
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions

    dev = ns_p1.device
    erng = np.random.default_rng(args.seed + 2)

    def full(N, P):
        return T(np.full(N, P), torch.int64)

    # Ragged N = 3: lengths2 of 0, 1 and P2 - 1, garbage coordinates (up to
    # 1e3) past them, and a box of its own per cloud (scale and offset).
    rag1 = erng.normal(size=(3, 3000, 3)).astype(np.float32)
    rag2 = erng.normal(size=(3, 5000, 3)).astype(np.float32)
    for n in range(3):
        rag1[n] = rag1[n] * (n + 1) + 10 * n
        rag2[n] = rag2[n] * (n + 1) + 10 * n
    rag_l2 = np.array([0, 1, 4999])
    for n, length in enumerate(rag_l2):
        rag2[n, length:] = erng.uniform(-1e3, 1e3, size=(5000 - length, 3))
    # Every candidate twice (the copies far apart in index, near in Morton
    # order), every fifth query a candidate.
    base = erng.normal(size=(1, 10000, 3)).astype(np.float32)
    dup1 = erng.normal(size=(1, 10000, 3)).astype(np.float32)
    dup1[0, ::5] = base[0, erng.integers(0, 10000, size=2000)]
    cases = [
        ("north star", ns_p1, ns_p2, full(1, 100000), (16, 100), False),
        ("config 1", pc1.points_padded(), pc2.points_padded(),
         pc2.num_points_per_cloud(), (8,), True),
        ("tie cloud 20k", tie1, tie2, full(1, 20000), (16,), True),
        ("ragged 3 x 3000 x 5000", T(rag1), T(rag2), T(rag_l2, torch.int64),
         (16, 100), True),
        ("duplicated 10k x 2 x 10k", T(dup1), T(np.concatenate([base, base], 1)),
         full(1, 20000), (16, 100), True),
    ]
    t0 = time.perf_counter()
    for label, q, r, l2, Ks, vs_plain in cases:
        N, P1 = q.shape[:2]
        l1 = full(N, P1)
        for K in Ks:
            for norm in (1, 2):
                base_out = kk.knn_topk_cuda(q, r, l2, K, norm, sort_queries=False)
                d, i = kk.knn_topk_cuda(q, r, l2, K, norm, sort_queries=True)
                what = f"sorted knn {label} K={K} norm={norm}"
                require(torch.equal(d, base_out[0]), f"{what}: dists")
                require(torch.equal(i, base_out[1]), f"{what}: idx")
                if vs_plain:
                    ref = _apply_pad_conventions(*kk.knn_topk_plain(q, r, l2, K, norm),
                                                 l1, l2, K, P1)
                    dk, ik = _apply_pad_conventions(d, i, l1, l2, K, P1)
                    require(torch.equal(dk, ref[0]) and torch.equal(ik, ref[1]),
                            f"{what}: differs from knn_topk_plain")
    print(f"phase 4: knn with the queries sorted bit-equal to unsorted, "
          f"both norms, at {'; '.join(f'{c[0]} K={c[4]}' for c in cases)}; equal to "
          f"knn_topk_plain but at the north star ({time.perf_counter() - t0:.1f} s)")
    # Other dimensions: the queries sort at any D.
    for D in (1, 2, 5):
        q, r = T(grid_points(erng, (2, 700, D))), T(grid_points(erng, (2, 900, D)))
        l2 = T(np.array([900, 444]), torch.int64)
        out = kk.knn_topk_cuda(q, r, l2, 8, 2, sort_queries=False)
        srt = kk.knn_topk_cuda(q, r, l2, 8, 2, sort_queries=True)
        require(torch.equal(out[0], srt[0]) and torch.equal(out[1], srt[1]),
                f"sorted queries D={D}: differ from unsorted")
    print("  D in {1, 2, 5}: sorted queries bit-equal to unsorted")

    # The counters of one launch at the north star, K=16: unsorted and sorted.
    # Insertions depend on each query's scan order only: equal with the
    # queries sorted, and no query inserts fewer than K.
    ns_len = full(1, 100000)
    counts = {}
    for name, sq in (("unsorted", False), ("queries", True)):
        c = kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, 16, 2, sort_queries=sq,
                             instrument=True)[2]
        counts[name] = dict(zip(kk.COUNTERS, c.sum(dim=(0, 1)).tolist()))
        counts[name]["fired_share"] = counts[name]["fired"] / counts[name]["groups"]
    print("  north-star K=16 counters (groups, fired votes, drains with work, "
          f"insertions, pending appends): {json.dumps(counts)}")
    require(counts["unsorted"]["admissions"] == counts["queries"]["admissions"],
            "counters: insertions differ with the queries sorted")
    require(all(c["admissions"] >= 16 * 100000 for c in counts.values()),
            "counters: fewer insertions than K a query")
    ms = {name: cuda_ms(lambda: kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, 16, 2,
                                                 sort_queries=sq), reps=5)
          for name, sq in (("unsorted", False), ("queries", True), ("auto", None))}
    print(f"  north-star knn_topk_cuda K=16 ms, sorts included: {json.dumps(ms)}")

    # Config 4: one cloud of 1M queries against 1M points, K=16, forward and
    # backward through knn_points, as a main path: every launch counter set
    # to 0 just before and read just after.
    c4_p1 = torch.randn((1, 1_000_000, 3), generator=torch.Generator(device=dev)
                        .manual_seed(args.seed + 40), device=dev)
    c4_p2 = torch.randn((1, 1_000_000, 3), generator=torch.Generator(device=dev)
                        .manual_seed(args.seed + 41), device=dev)
    c4_counters = ("knn_topk_cuda", "scatter_add_rows")
    reset_launches()
    # -- the config 4 main path: nothing but what a user would call --
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out4, g1, g2 = knn_step(c4_p1, c4_p2, None, None, 16)
    torch.cuda.synchronize()
    c4_ms = (time.perf_counter() - t0) * 1e3
    launches4 = launch_counts(c4_counters)
    # -- end of the config 4 main path --
    print(f"  config 4 launches {json.dumps(launches4)}; fwd+bwd {c4_ms:.1f} ms "
          "(first call)")
    require(all(v > 0 for v in launches4.values()), "a kernel of config 4 never ran")
    require(bool(torch.isfinite(out4.dists).all()) and bool(torch.isfinite(g1).all())
            and bool(torch.isfinite(g2).all()) and g2.abs().max() > 0,
            "config 4: dists or gradients not finite, or no gradient into p2")
    c4_len = full(1, 1_000_000)
    auto = kk.knn_topk_cuda(c4_p1, c4_p2, c4_len, 16, 2)
    unsorted = kk.knn_topk_cuda(c4_p1, c4_p2, c4_len, 16, 2, sort_queries=False)
    require(torch.equal(auto[1], unsorted[1]) and torch.equal(auto[0], unsorted[0]),
            "config 4: auto-sorted knn differs from unsorted")
    # The main path's step against the same step through the plain twins on
    # the card: every query's indices and distances, both gradients.
    t0 = time.perf_counter()
    with plain_path():
        out4p, g1p, g2p = knn_step(c4_p1, c4_p2, None, None, 16)
    torch.cuda.synchronize()
    plain4_s = time.perf_counter() - t0
    require(torch.equal(out4.idx, out4p.idx), "config 4: idx differ from the plain path")
    derr4 = (out4.dists - out4p.dists).abs().max().item()
    gerr4 = [(a - b).abs().max().item() for a, b in ((g1, g1p), (g2, g2p))]
    note_err("knn", derr4)
    require(derr4 <= TOL, f"config 4: dists err {derr4} against the plain path")
    require(torch.allclose(g1, g1p, rtol=TOL, atol=TOL)
            and torch.allclose(g2, g2p, rtol=TOL, atol=TOL),
            f"config 4: gradients differ from the plain path (max abs err {gerr4})")
    # The backward's scatter at this shape, 16M entries into 1M rows:
    # bit-equal run to run and to the plain twin on CPU copies, within TOL
    # of the plain twin on the card.
    idx4 = out4.idx.reshape(1, -1)
    contrib4 = torch.randn((1, idx4.shape[1], 3), device=dev)
    s4 = hold_scatter(ks.scatter_add_rows, idx4, contrib4, 1_000_000, "config 4 scatter")
    serr4 = (s4 - ks.scatter_add_plain(idx4, contrib4, 1_000_000)).abs().max().item()
    note_err("rows", serr4)
    require(serr4 <= TOL, f"config 4 scatter: err {serr4}")
    fwd = {name: cuda_ms(lambda: kk.knn_topk_cuda(c4_p1, c4_p2, c4_len, 16, 2,
                                                  sort_queries=sq), reps=3)
           for name, sq in (("unsorted", False), ("auto", None))}
    with torch.no_grad():
        fwd["knn_points"] = wall_ms(lambda: ppt.knn_points(c4_p1, c4_p2, K=16), reps=3)
    step = wall_ms(lambda: knn_step(c4_p1, c4_p2, None, None, 16), reps=3)
    scatter4_line, _ = scatter_line(idx4, contrib4, 1_000_000, reps=3)
    print(f"  config 4 1M x 1M K=16: auto-sorted idx and dists equal to unsorted; the "
          f"step equal to the plain path's ({plain4_s:.1f} s): idx equal, dists max abs "
          f"err {derr4:.3g}, grads {gerr4[0]:.3g} / {gerr4[1]:.3g}; the scatter of "
          f"{idx4.shape[1]:,} entries bit-equal to the CPU twin, err {serr4:.3g} on the "
          f"card; forward ms {json.dumps(fwd)}; fwd+bwd {step:.1f} ms (backward "
          f"{step - fwd['knn_points']:.1f}); the scatter: {scatter4_line}")

    # packed/padded and sample_pdf on the card: equal to the same calls on CPU
    # tensors (the conversions and their gradients exactly; samples within
    # TOL, as cumulative sums add in another order on the card).
    sizes = (700, 0, 1300, 5)
    first = np.concatenate([[0], np.cumsum(sizes[:-1])])
    packed = erng.normal(size=(sum(sizes), 4, 3)).astype(np.float32)
    w = erng.normal(size=(len(sizes), max(sizes), 4, 3)).astype(np.float32)
    res = []
    for device in (dev, "cpu"):
        x = torch.tensor(packed, device=device, requires_grad=True)
        padded = ppt.packed_to_padded(x, torch.tensor(first, device=device), max(sizes))
        y = padded.detach().clone().requires_grad_(True)
        back = ppt.padded_to_packed(y, first.tolist(), sum(sizes))
        (padded * torch.tensor(w, device=device)).sum().backward()
        (back * back).sum().backward()
        res.append([t.detach().cpu() for t in (padded, x.grad, back, y.grad)])
    require(all(torch.equal(a, b) for a, b in zip(*res)),
            "packed_to_padded / padded_to_packed on the card differ from the CPU")
    bins = np.sort(erng.uniform(size=(64, 33)), axis=-1).astype(np.float32)
    wts = erng.uniform(size=(64, 32)).astype(np.float32)
    wts[::7] = 0.0
    on_card = ppt.sample_pdf(T(bins), T(wts), 128, det=True)
    on_cpu = ppt.sample_pdf(torch.tensor(bins), torch.tensor(wts), 128, det=True)
    err = (on_card.cpu() - on_cpu).abs().max().item()
    require(on_card.is_cuda and err <= TOL, f"sample_pdf on the card: err {err}")
    py_err = (ppt.sample_pdf_python(T(bins), T(wts), 128, det=True).cpu()
              - ppt.sample_pdf_python(torch.tensor(bins), torch.tensor(wts), 128,
                                      det=True)).abs().max().item()
    require(py_err <= TOL, f"sample_pdf_python on the card: err {py_err}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rand = ppt.sample_pdf(T(bins), T(wts), 128, det=False, generator=gen)
    require(bool(((rand >= T(bins[:, :1]) - 1e-6) & (rand <= T(bins[:, -1:]) + 1e-6)).all()),
            "sample_pdf det=False on the card: a sample outside its bins")
    print(f"  packed_to_padded, padded_to_packed and their gradients equal on card and "
          f"CPU; sample_pdf / sample_pdf_python det=True max abs err {err:.3g} / "
          f"{py_err:.3g}; det=False inside the support")
    return cases


def screen5(kk, p1, p2, lengths2, plan, s):
    """The north star's K=100 screen and select: bit-equal to the unseeded
    rounds, and to the plain twin on 4,096 rows (kernel order, queries
    sorted as the gate sorts them); the lists' lengths against the capacity
    and the queries flagged over 20 calls on fresh clouds; the screen's and
    the select's times beside the two seeded rounds they replaced, in one
    call (CUDA events, median of 10). The skip (D = 3): the screen's order
    (points, indices, boxes) equal to its plain twin, at the north star and
    on a ragged batch; the skipping screen's per-query counts and outputs
    equal to the full scan's (``_screen_skips`` off); its scanned share; a
    forced short last chunk (``_LIST_BYTES`` small) bit-equal to the
    unseeded rounds; at P2 = 16,384, K = 1,000 (``sample_s`` 1,024, lists of
    about a ninth of the cloud) the result bit-equal to unseeded and the
    screen's time with and without the skip."""
    from pytorch3d_pointops_tpu_torch.kernels import spatial_sort as ss

    dev = p1.device
    K, P2 = 100, p2.shape[1]
    base = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sample_bound=False)
    stats = []
    with no_host_sync():
        out = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, _stats=stats)
    require(torch.equal(out[0], base[0]) and torch.equal(out[1], base[1]),
            "screen and select K=100: differs from the unseeded rounds")
    real_skips = kk._screen_skips
    full_stats = []
    kk._screen_skips = lambda D: False
    try:
        full = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, _stats=full_stats)
    finally:
        kk._screen_skips = real_skips
    require(full_stats[0]["scanned"] is None and stats[0]["scanned"] is not None
            and torch.equal(stats[0]["counts"], full_stats[0]["counts"])
            and torch.equal(stats[0]["flags"], full_stats[0]["flags"])
            and torch.equal(full[0], out[0]) and torch.equal(full[1], out[1]),
            "the skipping screen: counts, flags or outputs differ from the full scan")
    share = stats[0]["scanned"].item()
    # The order against its twin: the north star, then a ragged batch with
    # garbage past lengths2 (0, 1, part; a cloud of 4 distinct points).
    g = torch.Generator(device=dev).manual_seed(7)
    rag = torch.randn((4, 20000, 3), device=dev, generator=g)
    rag[1, 1:] = 1e30
    rag[2, 13000:] = -1e30
    rag[3] = rag[3, torch.arange(20000, device=dev) % 4]
    rag_len = torch.tensor([20000, 1, 13000, 0], device=dev)
    for what, (pts, l2) in {"north star": (p2, lengths2),
                            "ragged": (rag, rag_len)}.items():
        got = kk.screen_order_cuda(pts, l2)
        want = kk.screen_order_plain(pts.cpu(), l2.cpu())
        require(torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1].cpu(), want[1]),
                f"screen order ({what}): differs from screen_order_plain")
    # A forced short last chunk: lists for 30,000 queries a launch.
    cap = kk.screen_cap(K, P2, s)
    real_bytes = kk._LIST_BYTES
    chunk_stats = []
    kk._LIST_BYTES = 8 * cap * 30000
    try:
        with no_host_sync():
            chunked = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, _stats=chunk_stats)
    finally:
        kk._LIST_BYTES = real_bytes
    require(torch.equal(chunked[0], base[0]) and torch.equal(chunked[1], base[1])
            and torch.equal(chunk_stats[0]["counts"], stats[0]["counts"]),
            "screen in chunks of 30,000 queries: differs from the unseeded rounds")
    rows = ss.morton_order(p1)
    rows32 = rows.int()
    seed = kk.seed_of(kk.kth_bounds(p1, p2, lengths2, [K], 2, s, rows)[0])
    shape = (kk._rounds(K, P2), 1, p1.shape[1], kk.ROUND_K)
    buf = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int64,
                                                      device=dev))
    screen = kk._screener(p1, p2, lengths2, 2, rows32)
    flags = screen(K, seed, cap, buf)
    sel = kk._join(list(buf[0]), list(buf[1]), K)
    sub = torch.arange(0, p1.shape[1], p1.shape[1] // 4096, device=dev)[:4096]
    ref = kk.knn_topk_plain(kk._gather_rows(p1, rows[:, sub]), p2, lengths2, K, 2)
    require(not flags.any() and torch.equal(sel[0][:, sub], ref[0])
            and torch.equal(sel[1][:, sub], ref[1]),
            "screen and select K=100: flagged queries, or rows differ from the plain twin")
    lengths, flagged = [], 0
    for _ in range(20):
        q = torch.randn(p1.shape, device=dev, generator=g)
        r = torch.randn(p2.shape, device=dev, generator=g)
        st = []
        with no_host_sync():
            kk.knn_topk_cuda(q, r, lengths2, K, 2, _stats=st)
        lengths.append(st[0]["counts"].flatten())
        flagged += int(st[0]["flags"].sum())
    c = torch.cat(lengths).float()
    rounds_seeds = [kk.seed_of(t) for t in kk.kth_bounds(p1, p2, lengths2,
                                                         kk._quantiles(K, P2), 2, s, rows)]
    launch = kk._launcher(p1, p2, lengths2, 2, plan, rows32)
    splan = kk.screen_plans(p1, p2, 2)[0]
    ms = {
        "screen and select": cuda_ms(lambda: screen(K, seed, cap, buf), reps=10),
        "two seeded rounds (the parent's)": cuda_ms(
            lambda: kk._chain(launch, K, P2, rounds_seeds), reps=10),
        "bounds (one quantile)": cuda_ms(
            lambda: kk.kth_bounds(p1, p2, lengths2, [K], 2, s, rows), reps=10),
        "repair, nothing flagged": cuda_ms(
            lambda: kk._chain(launch, K, P2, None, flags,
                              (list(buf[0]), list(buf[1]))), reps=10),
        "order kernel": cuda_ms(lambda: kk.screen_order_cuda(p2, lengths2), reps=10),
    }
    order_p, order_boxes = kk.screen_order_cuda(p2, lengths2)
    lists = torch.empty((1, p1.shape[1], cap), dtype=torch.int64, device=dev)
    counts = torch.empty((1, p1.shape[1]), dtype=torch.int32, device=dev)
    lib, stream = kk._lib(), kk._build.stream_ptr(dev)
    for name, (cands, boxes) in {"screen kernel, full scan": (p2, None),
                                 "screen kernel, skipping": (order_p, order_boxes)}.items():
        args = (p1.data_ptr(), cands.data_ptr(), lengths2.data_ptr(), rows32.data_ptr(),
                seed.data_ptr(), None if boxes is None else boxes.data_ptr(), 1,
                p1.shape[1], P2, 3, 0,
                p1.shape[1], cap, 2, *splan, lists.data_ptr(), counts.data_ptr(), None,
                stream)
        ms[name] = cuda_ms(lambda args=args: lib.knn_screen(*args), reps=10)
    ms["select kernel"] = cuda_ms(lambda: lib.knn_select(
        lists.data_ptr(), counts.data_ptr(), lengths2.data_ptr(), seed.data_ptr(), 1,
        p1.shape[1], P2, 0, p1.shape[1], cap, K, buf[0].data_ptr(), buf[1].data_ptr(),
        flags.data_ptr(), stream), reps=10)
    print(f"  screen and select K=100 ({kk.plan_name(splan)}): bit-equal to the unseeded "
          f"rounds, 4,096 rows bit-equal to the plain twin; lists over 20 calls on fresh "
          f"clouds: mean {c.mean().item():.1f}, p99 {c.quantile(0.99).item():.0f}, max "
          f"{c.max().item():.0f} entries of {cap}, {flagged} of 2,000,000 queries flagged")
    print(f"  the skip: order equal to its twin (north star, ragged batch); counts, flags "
          f"and outputs equal to the full scan's; {share:.4f} of (warp, segment) pairs "
          f"scanned; chunks of 30,000 queries bit-equal to unseeded")
    print(f"  north-star K=100 ms (one call, queries sorted): "
          f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}; {gpu_line()}")
    require(flagged == 0, f"screen and select K=100: {flagged} queries flagged in 20 calls")

    # Lists over a ninth of the cloud: P2 = 16,384, K = 1,000, a 1,024-point
    # sample; the screen with and without the skip, the queries unsorted (as
    # the gate leaves them at this size) and sorted.
    q = torch.randn((1, 16384, 3), device=dev, generator=g)
    r = torch.randn((1, 16384, 3), device=dev, generator=g)
    l16 = torch.tensor([16384], device=dev)
    K16, s16 = 1000, 1024
    big = []
    with no_host_sync():
        got = kk.knn_topk_cuda(q, r, l16, K16, 2, sample_s=s16, _stats=big)
    want = kk.knn_topk_cuda(q, r, l16, K16, 2, sample_bound=False)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "P2 = 16,384, K = 1,000: the screen differs from the unseeded rounds")
    cap16 = kk.screen_cap(K16, 16384, s16)
    shape16 = (kk._rounds(K16, 16384), 1, 16384, kk.ROUND_K)
    buf16 = (torch.empty(shape16, device=dev),
             torch.empty(shape16, dtype=torch.int64, device=dev))
    t16 = {}
    for sort in (False, True):
        rows16 = ss.morton_order(q) if sort else None
        seed16 = kk.seed_of(kk.kth_bounds(q, r, l16, [K16], 2, s16, rows16)[0])
        screen16 = kk._screener(q, r, l16, 2, None if rows16 is None else rows16.int())
        name = "queries sorted" if sort else "queries unsorted"
        t16[f"{name}, skip"] = cuda_ms(lambda: screen16(K16, seed16, cap16, buf16), reps=10)
        kk._screen_skips = lambda D: False
        try:
            t16[f"{name}, full scan"] = cuda_ms(lambda: screen16(K16, seed16, cap16, buf16),
                                                reps=10)
        finally:
            kk._screen_skips = real_skips
        st = []
        kk._screener(q, r, l16, 2, None if rows16 is None else rows16.int(),
                     stats=st)(K16, seed16, cap16, buf16)
        t16[f"{name}, scanned share"] = st[0]["scanned"].item()
    c16 = big[0]["counts"].float()
    print(f"  P2 = 16,384, K = 1,000 (sample 1,024): bit-equal to unseeded; lists mean "
          f"{c16.mean().item():.0f} of cap {cap16} (cap / P2 {cap16 / 16384:.3f}); screen "
          f"and select ms (order included) and scanned shares "
          f"{json.dumps({k: round(v, 4) for k, v in t16.items()})}")


@contextlib.contextmanager
def no_host_sync():
    """Raise on any host sync a PyTorch op makes inside the block."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase5(cases, plain_path, note_err):
    """Kth-bound seeding of the KNN kernel: the north-star K=100
    ``knn_points`` step (seeded by default: screen and select) as a main
    path with its own launch counts, against the plain path on the card;
    seeded calls bit-equal to unseeded ones; the screen and select at the
    north star against the unseeded rounds and the plain twin on a sample
    of rows, its lists' lengths against the capacity and the queries
    flagged over 20 calls, its kernels' times beside the two seeded rounds
    it replaced; the repair forced by too-tight bounds; a raw ``ub=`` round
    bit-equal to the plain twin; the counters' insertions with and without
    a seed; seeded and unseeded times. Every seeded call runs under
    ``no_host_sync``."""
    import pytorch3d_pointops_tpu_torch as ppt
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    _, ns_p1, ns_p2, ns_len = cases[0][:4]
    dev = ns_p1.device
    s_ns = kk._default_sample_s(100000)

    # The north-star step at K=100, a main path: the sample pass, the screen
    # and the select with the queries sorted, the two repair launches (each
    # block returns at once unless a query of it is flagged) and the
    # backward's scatter, every launch counter set to 0 just before.
    q = ns_p1.detach().requires_grad_(True)
    r = ns_p2.detach().requires_grad_(True)
    c5 = ("knn_topk_cuda", "knn_screen_order_cuda", "knn_screen_cuda", "knn_select_cuda",
          "scatter_add_rows")
    reset_launches()
    # -- the K=100 main path: nothing but what a user would call --
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_host_sync():
        out = ppt.knn_points(q, r, K=100)
    out.dists.sum().backward()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches5 = launch_counts(c5)
    # -- end of the K=100 main path --
    print(f"phase 5: north-star K=100 launches {json.dumps(launches5)} (sample pass, "
          f"2 gated repair launches; the screen's order, screen, select; scatter); fwd+bwd {step_ms:.1f} ms "
          "(first call; the forward without a host sync)")
    require(launches5 == {"knn_topk_cuda": 3, "knn_screen_order_cuda": 1,
                          "knn_screen_cuda": 1, "knn_select_cuda": 1,
                          "scatter_add_rows": 1},
            f"north-star K=100: launches {launches5}")
    require(bool(torch.isfinite(out.dists).all()) and bool(torch.isfinite(q.grad).all())
            and q.grad.abs().max() > 0 and r.grad.abs().max() > 0,
            "north-star K=100: dists or gradients not finite or zero")
    q2 = ns_p1.detach().requires_grad_(True)
    r2 = ns_p2.detach().requires_grad_(True)
    t0 = time.perf_counter()
    with plain_path():
        outp = ppt.knn_points(q2, r2, K=100)
        outp.dists.sum().backward()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    derr = (out.dists - outp.dists).abs().max().item()
    gerr = [(a - b).abs().max().item() for a, b in ((q.grad, q2.grad), (r.grad, r2.grad))]
    note_err("knn", derr)
    require(torch.equal(out.idx, outp.idx), "north-star K=100: idx differ from the plain path")
    require(derr <= TOL and torch.allclose(q.grad, q2.grad, rtol=TOL, atol=TOL)
            and torch.allclose(r.grad, r2.grad, rtol=TOL, atol=TOL),
            f"north-star K=100: dists err {derr}, grads err {gerr} against the plain path")
    plan = kk.card_plans(ns_p1, ns_p2, 100, 2)[0]
    print(f"  against the plain path on the card ({plain_s:.1f} s): idx equal for all "
          f"100,000 queries, dists max abs err {derr:.3g}, grads {gerr[0]:.3g} / "
          f"{gerr[1]:.3g}")
    screen5(kk, ns_p1, ns_p2, ns_len, plan, s_ns)

    # Seeded bit-equal to unseeded: each case with the queries sorted and
    # not, both norms at the north star K=100; single rounds opt in with
    # sample_bound=True.
    rag = cases[3]
    sweep = [
        ("north star", ns_p1, ns_p2, ns_len, ((100, 1), (100, 2), (16, 2), (64, 2)), None),
        ("tie cloud 20k", *cases[2][1:4], ((100, 2), (16, 2)), None),
        ("duplicated 10k x 2 x 10k", *cases[4][1:4], ((100, 2), (16, 2)), None),
        # lengths2 0, 1 (under P2 // 2: bounds off) and P2 - 1, garbage past them.
        ("ragged 3 x 3000 x 5000", *rag[1:4], ((100, 2), (100, 1), (16, 2)), 1024),
    ]
    t0 = time.perf_counter()
    calls = 0
    for label, q, r, l2, kn, s in sweep:
        for K, norm in kn:
            base = kk.knn_topk_cuda(q, r, l2, K, norm, sort_queries=False,
                                    sample_bound=False)
            for sq in (False, True):
                with no_host_sync():
                    d, i = kk.knn_topk_cuda(q, r, l2, K, norm, sort_queries=sq,
                                            sample_bound=True, sample_s=s)
                calls += 1
                require(torch.equal(d, base[0]) and torch.equal(i, base[1]),
                        f"seeded knn {label} K={K} norm={norm} queries={sq}: "
                        "differs from unseeded")
    print(f"  seeded bit-equal to unseeded in {calls} calls, each sort, no host sync: "
          + "; ".join(f"{c[0]} (K, norm) {list(c[4])}" for c in sweep)
          + f" ({time.perf_counter() - t0:.1f} s)")

    # The repair forced: every bound -1. Seeded rounds (K=64, opted in)
    # leave SENT in every slot: the gate word is 1. At K=100 every screened
    # list is short of K: every query is flagged, both rounds run again, and
    # the result is the unseeded one.
    seeds = [kk.seed_of(torch.full((1, 100000), -1.0, device=dev))]
    bad = kk._launch_rounds(ns_p1, ns_p2, ns_len, 64, 2, plan, seeds=seeds)
    gate = int(kk.repair_gate([bad[1]], ns_len, 64))
    real = kk.kth_bounds
    kk.kth_bounds = lambda p1, p2, l2, kqs, norm, s, rows=None: [
        torch.full(p1.shape[:2], -1.0, device=p1.device) for _ in kqs]
    forced_stats = []
    try:
        reset_launches()
        with no_host_sync():
            forced = kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, 100, 2, _stats=forced_stats)
        forced_launches = launch_counts(c5[:4])
    finally:
        kk.kth_bounds = real
    base = kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, 100, 2, sample_bound=False)
    flagged = int(forced_stats[0]["flags"].sum())
    require(gate == 1 and flagged == 100000
            and forced_launches == {"knn_topk_cuda": 2, "knn_screen_order_cuda": 1,
                                    "knn_screen_cuda": 1, "knn_select_cuda": 1}
            and torch.equal(forced[0], base[0]) and torch.equal(forced[1], base[1]),
            f"forced repair: gate {gate}, {flagged} flagged, {forced_launches} "
            "launches, or not exact")
    # A raw ub= round (no repair) against the plain twin, SENT slots
    # included: a bound at each query's 8th distance, K=16.
    sub = ns_p1[:, :4096].contiguous()
    d16, _ = kk.knn_topk_cuda(sub, ns_p2, ns_len, 16, 2, sample_bound=False)
    ub = d16[..., 7].contiguous()
    for sq in (False, True):
        with no_host_sync():
            rk = kk.knn_topk_cuda(sub, ns_p2, ns_len, 16, 2, ub=ub, sort_queries=sq)
        rp = kk.knn_topk_plain(sub, ns_p2, ns_len, 16, 2, ub=ub)
        require(torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1]),
                f"raw ub= round (queries sorted {sq}): differs from the plain twin")
    print(f"  forced repair (bounds -1): K=64 repair word {gate}; K=100 {flagged:,} "
          f"queries flagged, launches {json.dumps(forced_launches)}, "
          f"result bit-equal to unseeded; raw ub= K=16 round bit-equal to the plain "
          f"twin on 4,096 queries, {int((rk[1] == kk.SENT).sum())} SENT slots")

    # Insertions with and without a seed: the counters of one launch, the
    # seed from the sampled bound of the round's own K.
    ins = {}
    for K in (16, 64):
        tau_k = kk.kth_bounds(ns_p1, ns_p2, ns_len, [K], 2, s_ns)[0]
        row = {}
        for name, kw in (("unseeded", {}), ("seeded", {"ub": tau_k})):
            for sq in (False, True):
                c = kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, K, 2, sort_queries=sq,
                                     instrument=True, **kw)[2]
                tot = dict(zip(kk.COUNTERS, c.sum(dim=(0, 1)).tolist()))
                row[f"{name}{' sorted' if sq else ''}"] = {
                    "insertions a query": tot["admissions"] / 100000,
                    "fired share": tot["fired"] / tot["groups"]}
        ins[K] = row
        require(row["seeded"]["insertions a query"] < row["unseeded"]["insertions a query"],
                f"K={K}: a seed did not cut the insertions")
    print(f"  north-star counters, one launch, unseeded / seeded at the sampled bound: "
          f"{json.dumps(ins)}")

    # Times at the north star: knn_topk_cuda with the queries sorted where the
    # gate sorts them, seeded against unseeded, and the bounds alone.
    ms = {}
    for K in (16, 64, 100):
        sb = None if K > kk.ROUND_K else True
        ms[K] = {
            "unseeded": cuda_ms(lambda: kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, K, 2,
                                                         sample_bound=False), reps=5),
            "seeded": cuda_ms(lambda: kk.knn_topk_cuda(ns_p1, ns_p2, ns_len, K, 2,
                                                       sample_bound=sb), reps=5),
            "bounds alone": cuda_ms(lambda: kk.kth_bounds(
                ns_p1, ns_p2, ns_len, kk._quantiles(K, 100000), 2, s_ns), reps=5),
        }
    print(f"  north-star knn_topk_cuda ms (queries sorted where gated; seeded K <= 64 "
          f"opted in): {json.dumps(ms)}")




def phase6(T, rng, plain_path):
    """The ring layer (``parallel/``) on the card, four shards of one
    ``("sp",)`` mesh on ``cuda:0`` (and a 2 x 2 ``("dp", "sp")`` mesh): its
    main path with its own launch counts (config 5's ring chamfer, five SGD
    steps; the north-star ring KNN at K=16 fwd+bwd and K=100 fwd), each
    shape against the single-card op (losses within rel 1e-5, indices
    equal, KNN distances bit-equal, gradients within 1e-5 of their largest
    entry, two backward runs bit-equal), the same ring calls again through
    the plain twins (``plain_path`` swaps the kernels' module attributes,
    which the ring looks up at every hop), the edges (shards past a cloud's
    length, shards smaller than K), and the ring's time beside the single
    card's. Returns each kernel's launches on the ring's main path."""
    import pytorch3d_pointops_tpu_torch as ppt
    from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.ops.chamfer import _nn_bidirectional
    from pytorch3d_pointops_tpu_torch.parallel import (
        make_mesh, ring_chamfer_distance, ring_knn_points)
    from pytorch3d_pointops_tpu_torch.parallel import ring as pr

    dev = torch.device("cuda", 0)
    mesh = make_mesh((4,), ("sp",), devices=[dev] * 4)
    require(all(d.type == "cuda" for d in mesh.devices.flat), "ring mesh not on the card")

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)

    def chamfer_case(N, P, lo):
        """Two ragged batches of N clouds of up to P points (lengths in
        [lo, P]) with normals and colors, on the card."""
        lens = [T(rng.integers(lo, P + 1, size=N), torch.int64) for _ in range(2)]
        pts = [T((s * rng.normal(size=(N, P, 3))).astype(np.float32)) for s in (1.5, 1.0)]
        feats = [{"normals": T(unit(rng.normal(size=(N, P, 3)))),
                  "colors": T(rng.uniform(size=(N, P, 3)).astype(np.float32))}
                 for _ in range(2)]
        return pts, lens, feats

    names = ["normals", "colors"]

    def cham_step(p, case, ring_mesh=None, **ring_kw):
        """One chamfer fwd+bwd, mean/mean with both feature terms: on the
        ring when a mesh is given, else single card. Returns the losses."""
        (_, y), (lx, ly), (fx, fy) = case
        if ring_mesh is None:
            loss, lf = ppt.chamfer_distance(p, y, lx, ly, fx, fy, feature_names=names)
        else:
            loss, lf = ring_chamfer_distance(p, y, lx, ly, fx, fy, feature_names=names,
                                             mesh=ring_mesh, **ring_kw)
        (loss + lf["normals"] + lf["colors"]).backward()
        return [loss.item(), lf["normals"].item(), lf["colors"].item()]

    def grad_check(what, g, ref):
        scale = ref.abs().max().item()
        err = (g - ref).abs().max().item()
        require(scale > 0 and err <= TOL * scale,
                f"{what}: gradient err {err} against largest entry {scale}")
        return err, scale

    def dist_err(what, a, b):
        err = (a - b).abs().max().item()
        require(err <= TOL, f"{what}: distances differ by {err}")
        return err

    def ring_vs_single_chamfer(what, p0, case, ring_mesh, **ring_kw):
        """Ring chamfer against single card at p0: losses, both NN index
        sets, gradients, and two ring backwards bit-equal. Then the ring
        and the single-card NN through the plain twins against the kernels:
        indices equal, distances, losses and gradients within TOL."""
        grads, losses = [], []
        for _ in range(2):
            q = p0.detach().clone().requires_grad_(True)
            losses.append(cham_step(q, case, ring_mesh, **ring_kw))
            grads.append(q.grad)
        require(torch.equal(grads[0], grads[1]), f"{what}: ring backward not bit-equal")
        q = p0.detach().clone().requires_grad_(True)
        single = cham_step(q, case)
        rels = [abs(a - b) / abs(b) for a, b in zip(losses[0], single)]
        require(all(r <= TOL for r in rels), f"{what}: losses {losses[0]} vs {single}")
        err, scale = grad_check(what, grads[0], q.grad)
        (_, y), (lx, ly), _ = case
        ring = pr._Ring(ring_mesh, "sp", ring_kw.get("batch_axis"))
        with torch.no_grad():
            rn = pr._RingNNBidir.apply(p0, y, lx, ly, ring, 2)
            (d1, i1), (d2, i2) = _nn_bidirectional(p0, y, lx, ly, 2)
        require(torch.equal(rn[1], i1) and torch.equal(rn[3], i2),
                f"{what}: nearest-neighbour indices differ from single card")
        require(torch.equal(rn[0], d1) and torch.equal(rn[2], d2),
                f"{what}: nearest-neighbour distances differ from single card")
        print(f"  {what}: ring vs single card: loss rel err {max(rels):.3g}, NN indices "
              f"equal both ways, grad max abs err {err:.3g} (largest entry "
              f"{scale:.3g}); two ring backwards bit-equal")
        with plain_path():
            q = p0.detach().clone().requires_grad_(True)
            plain = cham_step(q, case, ring_mesh, **ring_kw)
            with torch.no_grad():
                pn = pr._RingNNBidir.apply(p0, y, lx, ly, ring, 2)
                (pd1, pi1), (pd2, pi2) = _nn_bidirectional(p0, y, lx, ly, 2)
        require(torch.equal(rn[1], pn[1]) and torch.equal(rn[3], pn[3]),
                f"{what}: ring NN indices differ from the ring through the plain twins")
        require(torch.equal(i1, pi1) and torch.equal(i2, pi2),
                f"{what}: single-card NN indices differ from the plain twin")
        derr = max(dist_err(what, rn[0], pn[0]), dist_err(what, rn[2], pn[2]),
                   dist_err(what, d1, pd1), dist_err(what, d2, pd2))
        prels = [abs(a - b) / abs(b) for a, b in zip(losses[0], plain)]
        require(all(r <= TOL for r in prels),
                f"{what}: ring losses {losses[0]} vs plain twins {plain}")
        perr, pscale = grad_check(f"{what} vs plain twins", grads[0], q.grad)
        print(f"  {what}: ring vs ring through the plain twins: NN indices equal both "
              f"ways (and single card's vs its plain twin), dists max abs err "
              f"{derr:.3g}, loss rel err {max(prels):.3g}, grad max abs err {perr:.3g} "
              f"(largest entry {pscale:.3g})")

    def knn_step(q, r, l1, l2, K, ring_mesh=None, backward=True):
        q = q.detach().requires_grad_(backward)
        r = r.detach().requires_grad_(backward)
        if ring_mesh is None:
            out = ppt.knn_points(q, r, l1, l2, K=K)
        else:
            out = ring_knn_points(q, r, l1, l2, K=K, mesh=ring_mesh)
        if backward:
            (out.dists * torch.linspace(0.5, 1.5, K, device=dev)).sum().backward()
        return out, q.grad, r.grad

    def ring_vs_single_knn(what, q, r, l1, l2, K, backward=True):
        """Ring KNN against single card: indices equal, distances
        bit-equal, gradients within TOL of their largest entry, two ring
        backwards bit-equal; then against the ring through the plain
        twins: indices equal, distances and gradients within TOL."""
        outs = [knn_step(q, r, l1, l2, K, mesh, backward) for _ in range(2 if backward else 1)]
        ref, gq, gr = knn_step(q, r, l1, l2, K, None, backward)
        torch.cuda.synchronize()
        o = outs[0][0]
        require(torch.equal(o.idx, ref.idx), f"{what}: ring idx differ from single card")
        require(torch.equal(o.dists, ref.dists), f"{what}: ring dists not bit-equal")
        msg = ""
        if backward:
            require(torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2]),
                    f"{what}: ring backward not bit-equal")
            e1 = grad_check(what, outs[0][1], gq)[0]
            e2 = grad_check(what, outs[0][2], gr)[0]
            msg = f", grads max abs err {e1:.3g} / {e2:.3g}, two ring backwards bit-equal"
        print(f"  {what}: ring vs single card: idx equal, dists bit-equal{msg}")
        with plain_path():
            pout, pgq, pgr = knn_step(q, r, l1, l2, K, mesh, backward)
        require(torch.equal(o.idx, pout.idx),
                f"{what}: ring idx differ from the ring through the plain twins")
        msg = f"dists max abs err {dist_err(what, o.dists, pout.dists):.3g}"
        if backward:
            e1 = grad_check(f"{what} vs plain twins", outs[0][1], pgq)[0]
            e2 = grad_check(f"{what} vs plain twins", outs[0][2], pgr)[0]
            msg += f", grads max abs err {e1:.3g} / {e2:.3g}"
        print(f"  {what}: ring vs ring through the plain twins: idx equal, {msg}")

    # Cut from BASELINE config 5 (256 clouds of 100k, sharded over >= 2
    # hosts): 16 clouds, 4 shards on one card -- one card and the script's
    # run time.
    N5, P5 = 16, 100000
    case5 = chamfer_case(N5, P5, 90000)
    ns_p1 = T(rng.normal(size=(1, 100000, 3)).astype(np.float32))
    ns_p2 = T(rng.normal(size=(1, 100000, 3)).astype(np.float32))
    print(f"phase 6: the ring on {mesh} (config 5 cut: batch 256 -> {N5}, >= 2 hosts "
          "-> 4 shards on one card, for one card and the script's run time)")

    counters = ("knn_topk_cuda", "chamfer_nn_cuda", "scatter_add_rows", "scatter_add_k1")
    reset_launches()
    # -- the ring's main path: nothing but what a user would call --
    p = case5[0][0].clone().requires_grad_(True)
    lr = 0.2 * N5 * P5
    losses, step_ms, parts = [], [], {}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(cham_step(p, case5, mesh)[0])
        with torch.no_grad():
            p -= lr * p.grad
        p.grad = None
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    parts["config 5 ring chamfer, 5 steps"] = launch_counts(counters)
    t0 = time.perf_counter()
    knn_step(ns_p1, ns_p2, None, None, 16, mesh)
    torch.cuda.synchronize()
    ring_k16_first = (time.perf_counter() - t0) * 1e3
    parts["north-star ring knn K=16 fwd+bwd"] = launch_counts(counters)
    knn_step(ns_p1, ns_p2, None, None, 100, mesh, backward=False)
    torch.cuda.synchronize()
    ring_launches = launch_counts(counters)
    # -- end of the ring's main path --
    prev = dict.fromkeys(counters, 0)
    for label, now in list(parts.items()) + [("north-star ring knn K=100 fwd",
                                              ring_launches)]:
        print(f"  ring launches, {label}: "
              f"{json.dumps({k: now[k] - prev[k] for k in now})}")
        prev = now
    require(all(ring_launches[c] > 0 for c in counters[:3]),
            f"a kernel of the ring path never ran: {ring_launches}")
    d_cham = parts["config 5 ring chamfer, 5 steps"]
    require(d_cham["chamfer_nn_cuda"] == 5 * 16 and d_cham["knn_topk_cuda"] == 0,
            f"config 5 ring chamfer: {d_cham} (4 x 4 hops a forward)")
    d_k16 = {k: parts["north-star ring knn K=16 fwd+bwd"][k] - d_cham[k] for k in d_cham}
    require(d_k16["knn_topk_cuda"] == 16 and d_k16["scatter_add_rows"] == 16,
            f"north-star ring K=16: {d_k16} (4 x 4 hops each way)")
    print(f"  config 5 ring chamfer losses {losses}; step ms "
          f"{[round(t, 3) for t in step_ms]}, median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], "ring loss did not fall")

    # Each shape against single card.
    ring_vs_single_chamfer("config 5 ring chamfer 16 x 100k", p, case5, mesh)
    ring_vs_single_knn("north-star ring knn K=16", ns_p1, ns_p2, None, None, 16)
    ring_vs_single_knn("north-star ring knn K=100 (fwd)", ns_p1, ns_p2, None, None, 100,
                       backward=False)

    # Edges: lengths that leave whole shards empty or nearly so, a shard
    # smaller than K, and both kernels' raw output on such shards.
    P = 1000
    rq = T(rng.normal(size=(3, P, 3)).astype(np.float32))
    rr = T(rng.normal(size=(3, P, 3)).astype(np.float32))
    l1e = T(np.array([P, P - 1, 1]), torch.int64)
    l2e = T(np.array([0, 1, P - 1]), torch.int64)
    ring_vs_single_knn("ragged knn, lengths2 0 / 1 / P-1, K=16", rq, rr, l1e, l2e, 16)
    ring_vs_single_knn("knn over shards of 10 points, K=16", rq[:, :40], rr[:, :40],
                       None, None, 16)
    rag = ((rq, rr), (l1e, l2e),
           tuple({"normals": T(unit(rng.normal(size=(3, P, 3)))),
                  "colors": T(rng.uniform(size=(3, P, 3)).astype(np.float32))}
                 for _ in range(2)))
    ring_vs_single_chamfer("ragged chamfer, lengths 0 / 1 / P-1", rq, rag, mesh)
    empty = T(np.array([0, 10, 3]), torch.int64)
    kargs = (rq[:, :250].contiguous(), rr[:, :10].contiguous(), empty, 16, 2)
    d, i = kk.knn_topk_cuda(*kargs)
    slot = torch.arange(16, device=dev)[None, None, :] >= empty[:, None, None]
    require(bool(torch.isinf(d[slot.expand_as(d)]).all())
            and int(i[slot.expand_as(i)].abs().sum()) == 0
            and bool(torch.isfinite(d[~slot.expand_as(d)]).all()),
            "knn_topk_cuda on a shard of 10 points (lengths2 0 / 10 / 3), K=16: slots "
            "past lengths2 are not (inf, 0)")
    dp, ip = kk.knn_topk_plain(*kargs)
    require(torch.equal(i, ip) and torch.allclose(d, dp, rtol=0, atol=TOL),
            "knn_topk_cuda on a shard of 10 points: differs from its plain twin")
    cargs = (rq[:, :250].contiguous(), rr[:, :250].contiguous(),
             T(np.array([250, 0, 7]), torch.int64), T(np.array([0, 250, 250]), torch.int64),
             2)
    d1, i1, d2, i2 = kc.chamfer_nn_cuda(*cargs)
    require(bool(torch.isinf(d1[0]).all()) and int(i1[0].abs().sum()) == 0
            and bool(torch.isinf(d2[1]).all()) and int(i2[1].abs().sum()) == 0,
            "chamfer_nn_cuda: a fully masked side is not (inf, 0)")
    pd1, pi1, pd2, pi2 = kc.chamfer_nn_plain(*cargs)
    require(torch.equal(i1, pi1) and torch.equal(i2, pi2)
            and torch.allclose(d1, pd1, rtol=0, atol=TOL)
            and torch.allclose(d2, pd2, rtol=0, atol=TOL),
            "chamfer_nn_cuda on empty and short sides: differs from its plain twin")
    print("  raw kernels on empty and short shards: knn_topk_cuda slots past lengths2 "
          "(inf, 0), chamfer_nn_cuda masked sides (inf, 0); both equal to their plain "
          "twins (indices equal, distances within TOL, inf where the twin has inf)")

    # The 2-D mesh at config 3's size: batch over dp, points over sp.
    mesh2 = make_mesh((2, 2), ("dp", "sp"), devices=[dev] * 4)
    case3 = chamfer_case(16, 10000, 9000)
    ring_vs_single_chamfer("config 3 ring chamfer on a 2 x 2 dp x sp mesh",
                           case3[0][0], case3, mesh2, batch_axis="dp")

    # The ring's time beside the single card's, one card: the hops' copies
    # are no-ops there, so the ring can only cost time (its merges, its
    # extra launches, its host loop).
    def cham_timer(case, ring_mesh=None, **kw):
        return lambda: cham_step(case[0][0].detach().clone().requires_grad_(True), case,
                                 ring_mesh, **kw)

    times = {
        "config 5 chamfer 16 x 100k fwd+bwd": (
            wall_ms(cham_timer(case5, mesh), 3), wall_ms(cham_timer(case5), 3)),
        "config 3 chamfer 16 x 10k fwd+bwd, 2 x 2 mesh": (
            wall_ms(cham_timer(case3, mesh2, batch_axis="dp"), 5),
            wall_ms(cham_timer(case3), 5)),
        "north-star knn K=16 fwd+bwd": (
            wall_ms(lambda: knn_step(ns_p1, ns_p2, None, None, 16, mesh), 5),
            wall_ms(lambda: knn_step(ns_p1, ns_p2, None, None, 16), 5)),
        "north-star knn K=100 fwd": (
            wall_ms(lambda: knn_step(ns_p1, ns_p2, None, None, 100, mesh, False), 3),
            wall_ms(lambda: knn_step(ns_p1, ns_p2, None, None, 100, None, False), 3)),
    }
    print(f"  ring (4 shards on one card) vs single-card wall ms, median "
          f"(first ring K=16 call {ring_k16_first:.1f} ms); {gpu_line()}")
    for label, (ring_ms, single_ms) in times.items():
        print(f"    {label}: ring {ring_ms:.3f} ms, single card {single_ms:.3f} ms "
              f"({ring_ms / single_ms:.2f}x)")
    # One hop's kernel at the ring's shard shape (shard 0 against shard 0),
    # by CUDA events: 16 of them are the ring forward's kernel time.
    q25, r25 = ns_p1[:, :25000].contiguous(), ns_p2[:, :25000].contiguous()
    l25 = T(np.array([25000]), torch.int64)
    (x5, y5), (lx5, ly5), _ = case5
    x25, y25 = x5[:, :25000].contiguous(), y5[:, :25000].contiguous()
    lx25, ly25 = lx5.clamp(max=25000), ly5.clamp(max=25000)
    hop_ms = {
        "knn_topk_cuda 1 x 25k x 25k K=16": cuda_ms(
            lambda: kk.knn_topk_cuda(q25, r25, l25, 16, 2), reps=10),
        "knn_topk_cuda 1 x 25k x 25k K=100": cuda_ms(
            lambda: kk.knn_topk_cuda(q25, r25, l25, 100, 2), reps=5),
        "chamfer_nn_cuda 16 x 25k x 25k": cuda_ms(
            lambda: kc.chamfer_nn_cuda(x25, y25, lx25, ly25, 2), reps=5),
    }
    print("  one hop's kernel (CUDA events, ms; a ring forward runs 16): "
          + json.dumps({k: round(v, 4) for k, v in hop_ms.items()}))
    inputs = dict(case5=case5, ns=(ns_p1, ns_p2), edge=(rq, rr, l1e, l2e), rag=rag,
                  case3=case3)
    return ring_launches, times, inputs


# The ring across processes (phase 7). Four workers share cuda:0; NCCL
# refuses two ranks on one card, so their group is gloo and every hop is
# staged through the host (see PROCS_BACKEND).
PROCS = 4
PROCS_BACKEND = "gloo"
PROCS_JOIN_S = 300
CHAMFER_NAMES = ["normals", "colors"]


def procs_chamfer(p, case, mesh, **kw):
    """One ring chamfer fwd+bwd, mean/mean with both feature terms, on
    whole tensors (a mesh of this process's devices) or blocks (a process
    mesh). Returns the three losses."""
    from pytorch3d_pointops_tpu_torch.parallel import ring_chamfer_distance

    (_, y), (lx, ly), (fx, fy) = case
    loss, lf = ring_chamfer_distance(p, y, lx, ly, fx, fy, feature_names=CHAMFER_NAMES,
                                     mesh=mesh, **kw)
    (loss + lf["normals"] + lf["colors"]).backward()
    return [loss.item(), lf["normals"].item(), lf["colors"].item()]


def procs_knn(q, r, l1, l2, K, mesh, backward=True):
    """Ring KNN on whole tensors or blocks; the backward weighs the K
    columns 0.5 to 1.5 (on a process mesh each process sums its block's
    terms: the gradient of the global sum). Returns (out, grad q, grad r)."""
    from pytorch3d_pointops_tpu_torch.parallel import ring_knn_points

    q = q.detach().requires_grad_(backward)
    r = r.detach().requires_grad_(backward)
    out = ring_knn_points(q, r, l1, l2, K=K, mesh=mesh)
    if backward:
        (out.dists * torch.linspace(0.5, 1.5, K, device=out.dists.device)).sum().backward()
    return out, q.grad, r.grad


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def procs_steps(p0, case, mesh, lr, steps=5):
    """``steps`` SGD steps of the ring chamfer from ``p0``: the losses of
    each step, the first step's gradient and each step's wall ms (the
    ranks of a process mesh start each step together)."""
    import torch.distributed as dist

    dev = p0.device
    p = p0.detach().clone().requires_grad_(True)
    losses, ms, g0 = [], [], None
    for _ in range(steps):
        sync(dev)
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        losses.append(procs_chamfer(p, case, mesh))
        g0 = p.grad.clone() if g0 is None else g0
        with torch.no_grad():
            p -= lr * p.grad
        p.grad = None
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, g0, ms


def procs_reference(inputs, dev):
    """What phase 6's one-process ring (four shards of ``cuda:0``) gives on
    phase 7's inputs, as CPU tensors."""
    from pytorch3d_pointops_tpu_torch.parallel import make_mesh

    mesh = make_mesh((PROCS,), ("sp",), devices=[dev] * PROCS)
    mesh2 = make_mesh((2, 2), ("dp", "sp"), devices=[dev] * PROCS)
    ref = {}
    case5 = inputs["case5"]
    ref["steps"] = procs_steps(case5[0][0], case5, mesh, inputs["lr"])
    for key, (q, r, l1, l2, K, backward) in inputs["knn"].items():
        out, gq, gr = procs_knn(q, r, l1, l2, K, mesh, backward)
        ref[key] = (out.dists, out.idx, gq, gr)
    for key, (case, kw) in inputs["chamfer"].items():
        p = case[0][0].detach().clone().requires_grad_(True)
        mesh_ = mesh2 if kw else mesh
        ref[key] = (procs_chamfer(p, case, mesh_, **kw), p.grad)
    sync(dev)
    return _to(ref, torch.device("cpu"))


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


def procs_worker(rank: int, tmp: str, device: str) -> None:
    """One rank of phase 7: its position of a ``("sp",)`` process mesh on
    ``cuda:0`` (and of a 2 x 2 ``("dp", "sp")`` one). Runs the main path
    with its own launch counts, holds each of its output and gradient
    blocks against the one-process ring's, times a step and a hop, and
    writes ``rank<r>.json``. A failed check raises, which fails the
    parent's join. ``device`` is ``cuda:0`` (the CPU rehearses the flow)."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.parallel import multihost
    from pytorch3d_pointops_tpu_torch.parallel.mesh import NamedSharding
    from pytorch3d_pointops_tpu_torch.parallel.ring import _ProcessRing

    dev = torch.device(device)
    multihost.initialize("file://" + os.path.join(tmp, "init"), num_processes=PROCS,
                         process_id=rank, backend=PROCS_BACKEND)
    mesh = multihost.process_mesh((PROCS,), ("sp",), device=dev)
    mesh2 = multihost.process_mesh((2, 2), ("dp", "sp"), device=dev)
    saved = torch.load(os.path.join(tmp, "phase7.pt"), mmap=True)
    inputs, ref = _to(saved["inputs"], dev), saved["ref"]

    def spec(m):
        return ("dp", "sp", None) if m is mesh2 else (None, "sp", None)

    def block(t, m=mesh):
        """This rank's block of a whole (N, P, ...) tensor."""
        sp = spec(m) + (None,) * (t.dim() - 3)
        return NamedSharding(m, sp[:t.dim()]).shard(t).local

    def on_mesh(case, m=mesh):
        """A chamfer case with this rank's blocks of the points and
        features; the lengths stay global."""
        (x, y), lens, (fx, fy) = case
        return ((block(x, m), block(y, m)), lens,
                tuple({k: block(v, m) for k, v in f.items()} for f in (fx, fy)))

    def grad_err(what, g, whole, m=mesh):
        """``g`` within TOL of the largest entry of the whole reference."""
        scale = whole.abs().max().item()
        err = (g.cpu() - block(whole.to(dev), m).cpu()).abs().max().item()
        require(scale > 0 and err <= TOL * scale,
                f"rank {rank} {what}: gradient err {err} against largest entry {scale}")
        return err

    def loss_err(what, got, want):
        rels = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        require(all(r <= TOL for r in rels), f"rank {rank} {what}: losses {got} vs {want}")
        return max(rels)

    counters = ("knn_topk_cuda", "chamfer_nn_cuda", "scatter_add_rows")
    res = {"rank": rank, "transport": _ProcessRing(mesh, "sp", None).transport,
           "launches": {}, "errors": {}}

    # -- the main path: nothing but what a user would call --
    reset_launches()
    case5 = on_mesh(inputs["case5"])
    losses, g0, res["step_ms"] = procs_steps(case5[0][0], case5, mesh, inputs["lr"])
    res["launches"]["config 5 ring chamfer, 5 steps"] = launch_counts(counters)
    q, r, l1, l2, K, bwd = inputs["knn"]["north-star K=16"]
    ns16 = procs_knn(block(q), block(r), l1, l2, K, mesh, bwd)
    res["launches"]["+ north-star ring knn K=16 fwd+bwd"] = launch_counts(counters)
    q, r, l1, l2, K, bwd = inputs["knn"]["north-star K=100 (fwd)"]
    ns100 = procs_knn(block(q), block(r), l1, l2, K, mesh, bwd)
    sync(dev)
    res["launches"]["+ north-star ring knn K=100 fwd"] = launch_counts(counters)
    # -- end of the main path --

    rlosses, rg0, _ = ref["steps"]
    res["losses"] = losses
    res["errors"]["config 5 ring chamfer, 5 steps"] = {
        "loss_rel": max(loss_err(f"config 5 step {i}", a, b)
                        for i, (a, b) in enumerate(zip(losses, rlosses))),
        "grad": grad_err("config 5 first step", g0, rg0),
        "grad_bit_equal": bool(torch.equal(g0.cpu(), block(rg0.to(dev)).cpu())),
    }
    outs = {"north-star K=16": ns16, "north-star K=100 (fwd)": ns100}
    for key, (q, r, l1, l2, K, bwd) in inputs["knn"].items():
        out, gq, gr = outs[key] if key in outs else procs_knn(
            block(q), block(r), l1, l2, K, mesh, bwd)
        d_ref, i_ref, gq_ref, gr_ref = ref[key]
        require(torch.equal(out.idx.cpu(), block(i_ref.to(dev)).cpu()),
                f"rank {rank} {key}: indices differ from the one-process ring")
        require(torch.equal(out.dists.cpu(), block(d_ref.to(dev)).cpu()),
                f"rank {rank} {key}: distances not bit-equal to the one-process ring")
        e = {"idx_equal": True, "dists_bit_equal": True}
        if bwd:
            e["grad_q"] = grad_err(f"{key} grad q", gq, gq_ref)
            e["grad_r"] = grad_err(f"{key} grad r", gr, gr_ref)
        res["errors"][key] = e
    for key, (case, kw) in inputs["chamfer"].items():
        m = mesh2 if kw else mesh
        c = on_mesh(case, m)
        p = c[0][0].detach().clone().requires_grad_(True)
        got = procs_chamfer(p, c, m, **kw)
        res["errors"][key] = {"loss_rel": loss_err(key, got, ref[key][0]),
                              "grad": grad_err(key, p.grad, ref[key][1], m)}
        res.setdefault("chamfer_losses", {})[key] = got

    # Times, warm: a step is timed above; the north-star K=16 call again,
    # and one forward hop of the config 5 chamfer (its y shard, running
    # minima and argmins: 16 x 25,000 x (12 + 4 + 8) bytes).
    q, r, l1, l2, K, bwd = inputs["knn"]["north-star K=16"]
    qb, rb = block(q), block(r)
    knn_ms = []
    for _ in range(3):
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        procs_knn(qb, rb, l1, l2, K, mesh, True)
        sync(dev)
        knn_ms.append((time.perf_counter() - t0) * 1e3)
    res["knn16_ms"] = knn_ms
    ring = _ProcessRing(mesh, "sp", None)
    y5 = case5[0][1]
    travel = [y5, torch.zeros(y5.shape[:2], device=dev),
              torch.zeros(y5.shape[:2], dtype=torch.int64, device=dev)]
    # And one hop of the north-star ring KNN forward: its y shard alone.
    for key, tensors in (("hop", travel), ("hop_knn", [rb])):
        hop_ms = []
        for _ in range(6):
            sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            ring.exchange(tensors)
            sync(dev)
            hop_ms.append((time.perf_counter() - t0) * 1e3)
        res[f"{key}_ms"] = hop_ms[1:]
        res[f"{key}_bytes"] = sum(t.numel() * t.element_size() for t in tensors)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase7(inputs6, times6, dev):
    """The ring across processes on the card: ``PROCS`` spawned workers,
    one position each of a process mesh on ``cuda:0`` (gloo, every hop
    staged through the host), held against phase 6's one-process ring on
    the same inputs. Four processes share one card and their hops go
    through the host: the protocol's cost, not a scaling figure. Returns
    rank 0's launches on the main path."""
    import tempfile

    (x5, y5), (lx5, ly5), _ = inputs6["case5"]
    ns_p1, ns_p2 = inputs6["ns"]
    rq, rr, l1e, l2e = inputs6["edge"]
    inputs = {
        "case5": inputs6["case5"],
        "lr": 0.2 * x5.shape[0] * x5.shape[1],
        "knn": {
            "north-star K=16": (ns_p1, ns_p2, None, None, 16, True),
            "north-star K=100 (fwd)": (ns_p1, ns_p2, None, None, 100, False),
            "ragged knn, lengths2 0 / 1 / P-1, K=16": (rq, rr, l1e, l2e, 16, True),
            "knn over shards of 10 points, K=16": (rq[:, :40].contiguous(),
                                                   rr[:, :40].contiguous(),
                                                   None, None, 16, True),
        },
        "chamfer": {
            "ragged chamfer, lengths 0 / 1 / P-1": (inputs6["rag"], {}),
            "config 3 ring chamfer on a 2 x 2 dp x sp process mesh": (
                inputs6["case3"], {"batch_axis": "dp"}),
        },
    }
    t0 = time.perf_counter()
    ref = procs_reference(inputs, dev)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"inputs": _to(inputs, torch.device("cpu")), "ref": ref},
                   os.path.join(tmp, "phase7.pt"))
        ctx = torch.multiprocessing.start_processes(
            procs_worker, args=(tmp, str(dev)), nprocs=PROCS, join=False, start_method="spawn")
        deadline = time.monotonic() + PROCS_JOIN_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise RuntimeError(f"phase 7: the workers did not finish within "
                                   f"{PROCS_JOIN_S} s")
        res = []
        for r in range(PROCS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    print(f"phase 7: the ring across {PROCS} processes, one position each, all on "
          f"cuda:0; transport: {res[0]['transport']} ({time.perf_counter() - t0:.1f} s "
          "with the one-process reference)")
    require(all(x["transport"] == res[0]["transport"] for x in res), "transports differ")
    require(all(x["losses"] == res[0]["losses"] for x in res),
            "config 5 losses differ between ranks")
    require(all(x.get("chamfer_losses") == res[0].get("chamfer_losses") for x in res),
            "chamfer losses differ between ranks")
    for x in res:
        prev = {}
        for label, now in x["launches"].items():
            print(f"  rank {x['rank']} launches, {label}: "
                  f"{json.dumps({k: now[k] - prev.get(k, 0) for k in now})}")
            prev = now
        d5 = x["launches"]["config 5 ring chamfer, 5 steps"]
        d16 = {k: v - d5[k] for k, v in
               x["launches"]["+ north-star ring knn K=16 fwd+bwd"].items()}
        require(d5["chamfer_nn_cuda"] == 5 * PROCS and d5["knn_topk_cuda"] == 0
                and d5["scatter_add_rows"] > 0,
                f"rank {x['rank']} config 5: {d5} ({PROCS} hops a forward)")
        require(d16["knn_topk_cuda"] == PROCS and d16["scatter_add_rows"] == PROCS,
                f"rank {x['rank']} north-star K=16: {d16} ({PROCS} hops each way)")
    print(f"  config 5 losses (every rank) {res[0]['losses']}")
    for key, e in res[0]["errors"].items():
        worst = {k: (max(x["errors"][key][k] for x in res) if not isinstance(v, bool)
                     else all(x["errors"][key][k] for x in res))
                 for k, v in e.items()}
        print(f"  {key}: every rank's blocks vs the one-process ring: {json.dumps(worst)}")
    step = [max(x["step_ms"][i] for x in res) for i in range(len(res[0]["step_ms"]))]
    knn = [max(x["knn16_ms"][i] for x in res) for i in range(len(res[0]["knn16_ms"]))]
    print(f"  {PROCS} processes sharing one card, hops through the host: the "
          f"protocol's cost, not a scaling figure; {gpu_line()}")
    print(f"    config 5 chamfer fwd+bwd step ms (max over ranks) "
          f"{[round(t, 3) for t in step]}, median after warm-up "
          f"{statistics.median(step[1:]):.3f}; phase 6's one-process ring "
          f"{times6['config 5 chamfer 16 x 100k fwd+bwd'][0]:.3f}")
    print(f"    north-star knn K=16 fwd+bwd ms (max over ranks) "
          f"{[round(t, 3) for t in knn]}, median {statistics.median(knn):.3f}; "
          f"phase 6's one-process ring {times6['north-star knn K=16 fwd+bwd'][0]:.3f}")
    for key, label in (("hop", "config 5 chamfer forward"),
                       ("hop_knn", "north-star knn forward")):
        hop = [max(x[f"{key}_ms"][i] for x in res) for i in range(len(res[0][f"{key}_ms"]))]
        gb = res[0][f"{key}_bytes"] / 1e9
        print(f"    one hop of the {label} ({res[0][f'{key}_bytes']} bytes a rank each "
              f"way), ms (max over ranks) {[round(t, 3) for t in hop]}, median "
              f"{statistics.median(hop):.3f} ({gb / statistics.median(hop) * 1e3:.3f} "
              f"GB/s a rank)")
    return res[0]["launches"]["+ north-star ring knn K=100 fwd"]


# fps_block_kernel<DIM, SLOTS, T, 1>'s (registers, spill bytes), as ptxas
# reported them before the cluster instances joined the template (CUDA 12,
# sm_90a, -O3 -fmad=false): phase 1 holds the build to them.
FPS_BLOCK_PTXAS = {(0, 8, 1024): (40, 0), (0, 16, 1024): (48, 0), (0, 32, 1024): (64, 0),
                   (3, 8, 256): (58, 0), (3, 16, 256): (96, 0), (3, 16, 512): (96, 0),
                   (3, 16, 1024): (64, 0)}
# Phase 8: the kernels each example must launch on the card (by wrapper);
# the examples with none run for their checks.
EXAMPLE_KERNELS = {
    "pointclouds_basics": (),
    "packed_padded_walkthrough": (),
    "sample_pdf_demo": (),
    "knn_and_chamfer": ("knn_topk_cuda", "chamfer_nn_cuda", "scatter_add_rows",
                        "scatter_add_k1"),
    "fps_and_ball_query": ("fps_batched", "ball_query_cuda", "scatter_add_rows"),
    "covariances_demo": ("knn_topk_cuda",),
    "ring_parallel": ("knn_topk_cuda", "chamfer_nn_cuda", "scatter_add_rows"),
    "performance": ("knn_topk_cuda", "ball_query_cuda", "fps_batched", "fps_clustered"),
}
# Run again through the plain twins, on the card.
EXAMPLES_PLAIN = ("knn_and_chamfer", "fps_and_ball_query", "covariances_demo",
                  "ring_parallel")
# The SGD loops' outputs (keys "sgd_*"): rounding drifts apart over the 100
# (knn_and_chamfer) or 50 (ring_parallel) steps, so 1e-4 relative there.
SGD_TOL = 1e-4
EXAMPLE_PEAK_MB = 1024
SWEEP_CASES = 200


def figures(out: dict, prefix: str = "") -> dict:
    """An example's returned numbers as flat ``{"key.subkey": array}``."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(figures(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def phase8(plain_path, wrappers, dev):
    """The port's eight examples on the card, each ``main(device=dev)``
    with every launch counter set to 0 just before and read just after;
    four of them again through the plain twins. Their own prints go to
    ``build/chip_smoke_examples.log``. Returns each wrapper's launches
    summed over the examples."""
    import importlib
    import io

    from pytorch3d_pointops_tpu_torch import sweep

    log = io.StringIO()

    def run(name):
        mod = importlib.import_module(f"pytorch3d_pointops_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            print(f"===== {name} =====")
            out = mod.main(device=dev, seed=0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_all = time.perf_counter()
    results, totals = {}, dict.fromkeys(wrappers, 0)
    for name, needs in EXAMPLE_KERNELS.items():
        reset_launches()
        results[name], secs = run(name)
        fired = {k: v for k, v in launch_counts(wrappers).items() if v}
        for k, v in fired.items():
            totals[k] += v
        print(f"  {name}: {secs:.1f} s, launches {json.dumps(fired)}")
        require(all(fired.get(k, 0) > 0 for k in needs),
                f"example {name} did not launch {[k for k in needs if not fired.get(k)]}")
    for name in EXAMPLES_PLAIN:
        with plain_path():
            plain, secs = run(name)
        # Integers equal; floats within TOL (the SGD loops' within SGD_TOL)
        # of their largest entry.
        worst = sweep.compare(f"example {name}", figures(results[name]), figures(plain),
                              "kernels vs plain twins", scaled={"sgd_": SGD_TOL, "": TOL})
        print(f"  {name} through the plain twins ({secs:.1f} s): indices equal, the "
              f"largest difference {worst:.3g}")
    perf = results["performance"]
    held = perf["kernel_vs_plain"]
    ops = ", ".join(sorted({h["op"] for h in held}))
    print(f"  performance: {len(held)} kernel calls ({ops}) equal to their plain twins on "
          f"the same inputs, the largest difference "
          f"{max(h['max_abs_err'] for h in held):.3g}")
    largest = max(perf["peak_mb"])
    print(f"  performance figures ({gpu_line()}): {json.dumps(perf)}")
    require(perf["peak_mb"][largest] < EXAMPLE_PEAK_MB,
            f"knn_points K=32 at P={largest} peaked at {perf['peak_mb'][largest]:.1f} MB")
    from pytorch3d_pointops_tpu_torch import _build

    with open(os.path.join(_build.BUILD_DIR, "chip_smoke_examples.log"), "w") as f:
        f.write(log.getvalue())
    print(f"phase 8: the eight examples on the card in {time.perf_counter() - t_all:.1f} s; "
          f"launches {json.dumps(totals)}")
    return totals


def phase9(wrappers, dev):
    """The seeded sweep (``sweep.py``): ``SWEEP_CASES`` cases on CUDA
    tensors against the plain twins on CPU copies of the same inputs and
    against the host library. Returns, for each wrapper, the number of
    cases that launched it."""
    from pytorch3d_pointops_tpu_torch import native, sweep

    t0 = time.perf_counter()
    native.load()
    built = time.perf_counter() - t0
    cases = dict.fromkeys(wrappers, 0)
    worst, held = {}, 0
    for case in sweep.cases(SWEEP_CASES):
        reset_launches()
        got = sweep.run_case(case, dev)
        for w, n in launch_counts(wrappers).items():
            cases[w] += n > 0
        err = sweep.compare(case, got, sweep.run_case(case, "cpu"))
        worst[case.family] = max(worst.get(case.family, 0.0), err)
        held += sweep.check_native(case, got)
    print(f"phase 9: {SWEEP_CASES} seeded sweep cases on the card in "
          f"{time.perf_counter() - t0:.1f} s (host library built in {built:.1f} s): "
          f"every one equal to the plain twins (indices equal, values within {TOL}, "
          f"gradients within {TOL} of their largest entry), {held} of them to the host "
          f"library; largest value differences by family {json.dumps(worst)}; cases "
          f"that launched each kernel {json.dumps(cases)}")
    require(all(cases[w] for w in wrappers
                if w not in ("fps_clustered", "fps_resident", "fps_streaming")),
            f"a kernel the sweep covers never ran: {cases}")
    return cases


# The parameters of an empty case that size an axis: one of them 0 means the
# case has no pair of points or no slot, where no kernel may launch.
EMPTY_AXES = ("N", "P1", "P2", "P", "K", "M")


def refused(case, device) -> str:
    """Runs ``case`` on ``device``, which must refuse it with an exception
    raised on the host; returns its type's name. A CUDA error (a
    device-side assert, a failed launch) fails the script."""
    from pytorch3d_pointops_tpu_torch import sweep

    try:
        sweep.run_case(case, device)
    except Exception as e:  # the refusal the JAX package also makes
        require("CUDA" not in str(e) and "device-side" not in str(e),
                f"{case}: a CUDA error on {device}: {e}")
        return type(e).__name__
    raise AssertionError(f"{case}: returned on {device}, where the JAX package refuses")


def phase10(wrappers, dev):
    """The directed empty cases (``sweep.empty_cases()``) on CUDA tensors
    against the same calls on CPU tensors, then each kernel's entry point
    called directly where the op layer no longer calls it. Returns, for
    each wrapper, the number of cases that launched it."""
    from pytorch3d_pointops_tpu_torch import sweep
    from pytorch3d_pointops_tpu_torch.kernels import ball_query as kb
    from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    t0 = time.perf_counter()
    cases = dict.fromkeys(wrappers, 0)
    by_expect, refusals, worst = {}, {}, 0.0
    for case in sweep.empty_cases():
        reset_launches()
        if case.expect == "raises":
            refusals[str(case)] = [refused(case, dev), refused(case, "cpu")]
        else:
            got = sweep.run_case(case, dev)
            torch.cuda.synchronize()
            worst = max(worst, sweep.compare(case, got, sweep.run_case(case, "cpu"),
                                             "card vs CPU"))
        torch.cuda.synchronize()
        fired = {k: v for k, v in launch_counts(wrappers).items() if v}
        for name in fired:
            cases[name] += 1
        if any(case.p.get(axis) == 0 for axis in EMPTY_AXES):
            require(not fired, f"{case}: launched {fired} on an empty dimension")
        elif fired:
            print(f"  {case} ({case.expect}): launched {fired}")
        by_expect[case.expect] = by_expect.get(case.expect, 0) + 1
    ms = (time.perf_counter() - t0) * 1e3

    # The entry points themselves at P2 = 0 and with no entry: total, and
    # equal to their twins.
    p1 = torch.randn((2, 5, 3), device=dev)
    none = torch.zeros((2, 0, 3), device=dev)
    full = torch.full((2,), 5, dtype=torch.int64, device=dev)
    zero = torch.zeros((2,), dtype=torch.int64, device=dev)
    cpu = [t.cpu() for t in (p1, none, full, zero)]
    held = []
    for name, kernel, twin, args in (
        ("knn_topk", kk.knn_topk_cuda, kk.knn_topk_plain, (2, 2)),
        ("knn_topk K=70", kk.knn_topk_cuda, kk.knn_topk_plain, (70, 2)),
        ("chamfer_nn_bidir", kc.chamfer_nn_cuda, kc.chamfer_nn_plain, (2,)),
        ("ball_query", kb.ball_query_cuda, kb.ball_query_plain, (3, 1.0)),
    ):
        if name.startswith("knn"):
            got = kernel(p1, none, zero, *args)
            want = twin(cpu[0], cpu[1], cpu[3], *args)
        else:
            got = kernel(p1, none, full, zero, *args)
            want = twin(cpu[0], cpu[1], cpu[2], cpu[3], *args)
        torch.cuda.synchronize()
        require(all(g.shape == w.shape and torch.equal(g.cpu(), w)
                    for g, w in zip(got, want)), f"{name} at P2 = 0 differs from its twin")
        held.append(f"{name} at P2 = 0")
    for label, idx, contrib, P2 in (
        ("no entry into 2 x 5 rows", torch.zeros((2, 0), dtype=torch.int64, device=dev),
         torch.zeros((2, 0, 3), device=dev), 5),
        ("no entry into 4 x 4,096 rows (partitioned)",
         torch.zeros((4, 0), dtype=torch.int64, device=dev),
         torch.zeros((4, 0, 3), device=dev), 4096),
        ("4 entries into no row", torch.full((2, 4), -1, dtype=torch.int64, device=dev),
         torch.randn((2, 4, 3), device=dev), 0),
    ):
        got = ks.scatter_add_rows(idx, contrib, P2)
        torch.cuda.synchronize()
        want = ks.scatter_add_plain(idx.cpu(), contrib.cpu(), P2)
        require(got.shape == want.shape and torch.equal(got.cpu(), want),
                f"scatter {label} differs from its twin")
        held.append(f"scatter {label}")
    print(f"phase 10: {sum(by_expect.values())} directed empty cases "
          f"({json.dumps(by_expect)}) on the card in {ms:.1f} ms wall: every returning "
          f"case equal to the CPU path (shapes, indices, values within {TOL} (largest "
          f"difference {worst:.3g}), NaN where NaN), every refusal raised on the host on "
          f"both devices {json.dumps(sorted(set(map(tuple, refusals.values()))))}, no "
          f"launch where an axis is 0; cases that launched each kernel "
          f"{json.dumps(cases)}; the entry points called directly, equal to their twins: "
          f"{'; '.join(held)} [{gpu_line()}]")
    return cases


# The point_transformer_seg.b4x80k cell's clouds (benchmark/workloads).
PT_LENGTHS = [80000, 80000, 74213, 61857]


def room_clouds(rng, lengths, P):
    """Rooms as the Point Transformer cell's traffic makes them: points on
    the six faces of a box of 4-10 x 4-10 x 2.5-3.5 m and of 8-16 boxes of
    0.3-2 m a side standing in it, in proportion to area, jittered by 1 cm
    and shifted so that each axis starts at 0; colours uniform in [0, 1);
    a label in [0, 13) for each room face and each box. Returns padded xyz
    and rgb (N, P, 3) float32, zero past each length, and the labels of
    every valid point, packed."""
    N = len(lengths)
    xyz, rgb = np.zeros((N, P, 3), np.float32), np.zeros((N, P, 3), np.float32)
    labels, eye = [], np.eye(3)
    for n, L in enumerate(lengths):
        size = rng.uniform([4.0, 4.0, 2.5], [10.0, 10.0, 3.5])
        B = int(rng.integers(8, 17))
        ext = np.minimum(rng.uniform(0.3, 2.0, size=(B, 3)), size)
        corner = rng.uniform(size=(B, 3)) * (size - ext)
        corner[:, 2] = 0.0
        faces = [(c + side * e[a] * eye[a], e[(a + 1) % 3] * eye[(a + 1) % 3],
                  e[(a + 2) % 3] * eye[(a + 2) % 3])
                 for c, e in zip(np.vstack([np.zeros(3), corner]), np.vstack([size, ext]))
                 for a in range(3) for side in (0.0, 1.0)]
        o, u, v = (np.array(t) for t in zip(*faces))
        area = np.linalg.norm(u, axis=1) * np.linalg.norm(v, axis=1)
        f = rng.choice(len(area), size=L, p=area / area.sum())
        a, b = rng.uniform(size=(2, L, 1))
        pts = o[f] + a * u[f] + b * v[f] + rng.normal(scale=0.01, size=(L, 3))
        xyz[n, :L] = pts - pts.min(0)
        rgb[n, :L] = rng.uniform(size=(L, 3))
        surface = np.where(f < 6, f, 6 + (f - 6) // 6)
        labels.append(rng.integers(0, 13, size=6 + B)[surface])
    return xyz, rgb, np.concatenate(labels)


def pt_kernels(model, xyz, lengths, note_err):
    """Phase 2 at the Point Transformer cell's shapes: the plan of clouds
    ``xyz`` with ``lengths`` (host ints), and every kernel it runs held to
    its plain twin on the plan's own inputs. Each FPS of the four sampled
    levels (K = L // 4 of each ragged cloud) under every entry point that
    takes its clouds, equal to ``fps_plain`` and to the plan; the KNN of
    every level (self at each level's nsample, each TransitionDown's at its
    nsample, each TransitionUp's 3 nearest coarser points; ragged
    cross-level batches), distances and indices equal; the scatter at the
    gathers' widest shapes (the attention's k and v at levels 1 and 5: C =
    64 into every level-1 row, C = 1,024 into the 1,154 of level 5; a
    TransitionDown's and a TransitionUp's at C = 32), bit-equal run to run
    and to the CPU twin, within TOL of the twin on the card; and the
    gathers' backward through ``masked_gather`` and ``knn_gather`` at the
    two attention shapes, bit-equal to the CPU twin."""
    from pytorch3d_pointops_tpu_torch.kernels import fps as kf
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.ops import knn_gather, masked_gather
    from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions

    dev = xyz.device
    plan = model.plan(xyz, lengths)

    def ints(values):
        return torch.tensor(values, dtype=torch.int64, device=dev)

    block_cap, resident_cap = kf.fps_limits(3, dev)
    cluster_cap = kf.cluster_limit(3, dev)
    fps_lines = []
    for i in range(1, len(plan)):
        above, level = plan[i - 1], plan[i]
        pts, lens, Ks = above.xyz, ints(above.lengths), ints(level.lengths)
        starts, max_K, P = torch.zeros_like(lens), max(level.lengths), pts.shape[1]
        ref = kf.fps_plain(pts, lens, Ks, starts, max_K)
        require(torch.equal(level.fps_idx, ref),
                f"point transformer level {i + 1} FPS: the plan differs from fps_plain")
        runs = [w for w, cap in ((kf.fps_batched, block_cap), (kf.fps_clustered, cluster_cap),
                                 (kf.fps_resident, resident_cap), (kf.fps_streaming, P))
                if P <= cap]
        for wrapper in runs:
            require(torch.equal(wrapper(pts, lens, Ks, starts, max_K), ref),
                    f"point transformer level {i + 1} FPS {wrapper.__name__} "
                    f"{above.lengths} K={level.lengths}: idx")
        fps_lines.append(f"{above.lengths} K={level.lengths} "
                         f"({', '.join(w.__name__ for w in runs)})")
    print(f"  point transformer FPS, equal to fps_plain and the plan: {'; '.join(fps_lines)}")

    def hold_knn(fine, coarse, K, what):
        l1, l2 = ints(fine.lengths), ints(coarse.lengths)
        got = _apply_pad_conventions(*kk.knn_topk_cuda(fine.xyz, coarse.xyz, l2, K, 2),
                                     l1, l2, K, fine.xyz.shape[1])
        want = _apply_pad_conventions(*kk.knn_topk_plain(fine.xyz, coarse.xyz, l2, K, 2),
                                      l1, l2, K, fine.xyz.shape[1])
        note_err("knn", (got[0] - want[0]).abs().max().item())
        require(torch.equal(got[0], want[0]), f"point transformer knn {what}: dists")
        require(torch.equal(got[1], want[1]), f"point transformer knn {what}: idx")
        return sum(a * b for a, b in zip(fine.lengths, coarse.lengths))

    pairs = 0
    for i, level in enumerate(plan):
        pairs += hold_knn(level, level, model.nsample[i], f"level {i + 1} self")
        if i:
            pairs += hold_knn(level, plan[i - 1], model.nsample[i], f"level {i + 1} down")
        if i + 1 < len(plan):
            pairs += hold_knn(level, plan[i + 1], 3, f"level {i + 1} up")
    print(f"  point transformer knn, K = {sorted(set(model.nsample))} and 3 over "
          f"{pairs:.4g} pairs: dists and idx equal to the plain twin")

    first, last = plan[0], plan[-1]
    scatters = (
        ("level 1 attention k and v", first.nbr_idx, 2 * model.planes[0], len(first.pos)),
        (f"level {len(plan)} attention k and v", last.nbr_idx, 2 * model.planes[-1],
         len(last.pos)),
        ("level 2 TransitionDown", plan[1].down_idx, model.planes[0], len(first.pos)),
        ("level 1 TransitionUp", first.up_idx, model.planes[0], len(plan[1].pos)),
    )
    for label, index, C, P2 in scatters:
        idx = index.reshape(1, -1)
        contrib = torch.randn((1, idx.shape[1], C), device=dev)
        what = f"point transformer {label}: {idx.shape[1]} entries into {P2} rows x {C}"
        out = hold_scatter(ks.scatter_add_rows, idx, contrib, P2, what)
        err = (out - ks.scatter_add_plain(idx, contrib, P2)).abs().max().item()
        note_err("rows", err)
        require(err <= TOL, f"{what}: err {err}")
        print(f"  {what} ({ks.scatter_plan(1, idx.shape[1], P2, C)}): bit-equal run to "
              f"run and to the CPU twin, max abs err {err:.3g} to the twin on the card")
    for label, index, C, P2 in scatters[:2]:
        for gather in (masked_gather, knn_gather):
            x = torch.randn((1, P2, C), device=dev, requires_grad=True)
            out = gather(x, index[None])
            require(torch.equal(out[0], x.detach()[0][index]),
                    f"point transformer {label} {gather.__name__}: forward")
            g = torch.randn_like(out)
            out.backward(g)
            want = ks.scatter_add_plain(index.reshape(1, -1).cpu(),
                                        g.reshape(1, -1, C).cpu(), P2)
            require(torch.equal(x.grad.cpu(), want),
                    f"point transformer {label} {gather.__name__}: backward not bit-equal "
                    "to the CPU twin")
    print("  point transformer gathers' backward (masked_gather, knn_gather) at C = "
          f"{scatters[0][2]} and {scatters[1][2]}: bit-equal to the CPU twin")


def phase3c(model, xyz, rgb, labels, lengths, plain_path):
    """The Point Transformer's training step (plan, forward, cross-entropy,
    backward; no optimiser) as a main path with its launch counts and no
    host sync, two steps bit-equal, and the step against the plain path on
    the card with the scatter's twin on CPU copies (the kernels' sums): the
    plan, logits, loss and every gradient bit-equal."""
    import torch.nn.functional as F

    from pytorch3d_pointops_tpu_torch import tracing
    from pytorch3d_pointops_tpu_torch.kernels import fps as kf
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    def step():
        model.zero_grad(set_to_none=True)
        plan = model.plan(xyz, lengths)
        logits = model(xyz, rgb, lengths, plan)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        return plan, logits, loss, {n: p.grad for n, p in model.named_parameters()}

    counters = ("knn_topk_cuda", "fps_batched", "fps_clustered", "fps_resident",
                "fps_streaming", "scatter_add_rows", "ball_query_cuda", "chamfer_nn_cuda",
                "scatter_add_k1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # -- the Point Transformer main path: nothing but what a user would call --
    with no_host_sync():
        plan, logits, loss, grads = step()
    launches = launch_counts(counters)
    # -- end of the Point Transformer main path --
    syncs = tracing.counts("sync.")
    peak = torch.cuda.max_memory_allocated()
    levels = len(plan)
    block_cap = kf.fps_limits(3, xyz.device)[0]
    sampled = [plan[i].xyz.shape[1] for i in range(levels - 1)]
    # FPS: the levels above the block cap on the cluster path (2 and 3 at
    # the cell's sizes), the others on the block kernel, none on the grid
    # kernel. Each level's blocks and decoder block gather k and v; each
    # TransitionDown and TransitionUp but the coarsest one gathers once.
    want = {"fps_batched": sum(P <= block_cap for P in sampled),
            "fps_clustered": sum(P > block_cap for P in sampled),
            "fps_resident": 0, "fps_streaming": 0,
            "scatter_add_rows": sum(model.blocks) + 3 * levels - 2,
            "ball_query_cuda": 0, "chamfer_nn_cuda": 0, "scatter_add_k1": 0}
    print(f"phase 3c: point transformer {lengths}, {sum(plan[0].lengths)} points: "
          f"launches {json.dumps(launches)}; host syncs {syncs}; peak "
          f"{peak / 2**30:.2f} GiB")
    require({k: launches[k] for k in want} == want,
            f"point transformer launches {launches}, not {want}")
    require(launches["knn_topk_cuda"] >= 3 * levels - 2,
            f"point transformer: {launches['knn_topk_cuda']} KNN launches for "
            f"{3 * levels - 2} KNN calls")
    require(not syncs, f"point transformer step synced the host: {syncs}")
    step_ms = wall_ms(step, reps=3)
    print(f"  point transformer step (plan, forward, loss, backward) median {step_ms:.3f} "
          f"ms; loss {loss.item():.6g}")
    again = step()
    require(torch.equal(again[1], logits)
            and all(torch.equal(again[3][n], g) for n, g in grads.items()),
            "point transformer step not bit-equal run to run")

    def cpu_scatter(idx, contrib, P2):
        return ks.scatter_add_plain(idx.cpu(), contrib.cpu(), P2).to(contrib.device)

    with plain_path():
        ks.scatter_add_rows = cpu_scatter
        p_plan, p_logits, p_loss, p_grads = step()
    for i, (a, b) in enumerate(zip(plan, p_plan)):
        for name in ("fps_idx", "down_idx", "nbr_idx", "up_idx", "up_dist"):
            x, y = getattr(a, name), getattr(b, name)
            require((x is None and y is None) or torch.equal(x, y),
                    f"point transformer level {i + 1} {name}: differs from the plain path")
    require(torch.equal(logits, p_logits) and torch.equal(loss, p_loss),
            "point transformer logits or loss differ from the plain path")
    differ = [n for n, g in grads.items() if not torch.equal(g, p_grads[n])]
    require(not differ, f"point transformer gradients differ from the plain path: {differ}")
    print("  point transformer vs the plain path (scatter on CPU copies): plan, logits, "
          f"loss and all {len(grads)} gradients bit-equal; two steps bit-equal")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    started = time.perf_counter()
    sys.path.insert(0, REPO)
    import pytorch3d_pointops_tpu_torch as ppt
    from pytorch3d_pointops_tpu_torch import _build
    from pytorch3d_pointops_tpu_torch.kernels import ball_query as kb
    from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
    from pytorch3d_pointops_tpu_torch.kernels import fps as kf
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions
    from pytorch3d_pointops_tpu_torch.tune_scatter import library_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    def T(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # ---------------- phase 1: build and identify ----------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        with open(os.path.join(_build.BUILD_DIR, f"{name}.ptxas.log"), "w") as f:
            f.write(log)
        regs = [int(ln.split("Used")[1].split()[0]) for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [int(ln.split("bytes spill stores")[0].split(",")[-1])
                  for ln in log.splitlines() if "bytes spill stores" in ln]
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers, {sum(spills)} bytes of spill stores")
    knn_log = os.path.join(_build.BUILD_DIR, "knn.ptxas.log")
    if os.path.exists(knn_log):
        with open(knn_log) as f:
            knn_text = f.read()
        instances = kernel_instances(knn_text, "knn_topk_kernel")
        # knn_topk_kernel<KB, DIM, NORM, Q, CHAINED, COUNT>.
        by_dim = {}
        for key, (regs, spill) in sorted(instances.items()):
            bucket, _, _, q, chained, count = key
            by_dim.setdefault(key[1:3], []).append(
                f"KB{bucket}{'c' if chained else ''}{'n' if count else ''}"
                f"/Q{q}:{regs}r{f'+{spill}B' if spill else ''}")
        print("  knn_topk_kernel instances: KB<bucket>[c chained][n counting]"
              "/Q<queries a thread>:<registers>r[+<spill bytes>B]")
        for (kdim, knorm), items in sorted(by_dim.items()):
            print(f"  knn_topk_kernel DIM={kdim} norm={knorm}: {' '.join(items)}")
        spilled = [k for k, (_, s) in instances.items() if k[1] == 3 and s]
        require(instances and not spilled, f"knn D=3 instances spill: {spilled}")
        # Seeding reads its seeds and gate at run time: no instance of its own.
        require(len(instances) == 74, f"knn: {len(instances)} instances, not 74")
        require(any(k[5] for k in instances), "knn: no counting instance was built")
        # knn_screen_kernel<DIM, NORM, Q>: Q 1 and 2 at DIM 3 and 8, Q 1 at 0.
        screen_inst = kernel_instances(knn_text, "knn_screen_kernel")
        print("  knn_screen_kernel instances <DIM,NORM,Q> (registers, spill bytes): "
              + " ".join(f"<{','.join(map(str, k))}>:{regs}r{f'+{spill}s' if spill else ''}"
                         for k, (regs, spill) in sorted(screen_inst.items())))
        spilled = [k for k, (_, s) in screen_inst.items() if k[0] == 3 and s]
        require(len(screen_inst) == 10 and not spilled,
                f"knn_screen_kernel instances {sorted(screen_inst)}; D=3 spills: {spilled}")
    fps_log = os.path.join(_build.BUILD_DIR, "fps.ptxas.log")
    if os.path.exists(fps_log):
        with open(fps_log) as f:
            log = f.read()
        # fps_grid_kernel<DIM, SLOTS, THREADS> (csrc/fps.cu launch_grid_plan:
        # 5 at D=3, 4 at any D) and fps_block_kernel<DIM, SLOTS, THREADS,
        # CLUSTER> (launch_block_plan: 4 at D=3, 3 at any D, CLUSTER 1;
        # FPS_CLUSTER_PLANS: 3 x 4 at D=3, CLUSTER 2-16); DIM 0 is any D.
        fps_inst = {(name, *k): v for name in ("fps_grid_kernel", "fps_block_kernel")
                    for k, v in kernel_instances(log, name).items()}
        print("  fps instances (registers, spill bytes): " + " ".join(
            f"{name[4:-7]}<{','.join(map(str, k))}>:{regs}r{f'+{spill}s' if spill else ''}"
            for (name, *k), (regs, spill) in sorted(fps_inst.items())))
        spilled = [k for k, (_, s) in fps_inst.items() if k[1] == 3 and s]
        require(len(fps_inst) == 28 and not spilled,
                f"fps instances {sorted(fps_inst)}; D=3 spills: {spilled}")
        # The one-block instances are the kernel they were before the
        # cluster path: the same registers and no spill.
        block1 = {k[1:4]: v for k, v in fps_inst.items()
                  if k[0] == "fps_block_kernel" and k[4] == 1}
        require(block1 == FPS_BLOCK_PTXAS,
                f"fps_block_kernel CLUSTER=1 (registers, spill) {block1}, not {FPS_BLOCK_PTXAS}")
    bq_log = os.path.join(_build.BUILD_DIR, "ball_query.ptxas.log")
    if os.path.exists(bq_log):
        with open(bq_log) as f:
            # ball_query_kernel<DIM>: 3, 8 (D <= 8) and 0 (any D).
            bq_inst = kernel_instances(f.read(), "ball_query_kernel")
        print("  ball_query_kernel instances <DIM> (registers, spill bytes): "
              + " ".join(f"<{k[0]}>:{regs}r{f'+{spill}s' if spill else ''}"
                         for k, (regs, spill) in sorted(bq_inst.items())))
        spilled = [k for k, (_, s) in bq_inst.items() if k[0] == 3 and s]
        require(len(bq_inst) == 3 and not spilled,
                f"ball_query_kernel instances {sorted(bq_inst)}; D=3 spills: {spilled}")
    cham_log = os.path.join(_build.BUILD_DIR, "chamfer_nn.ptxas.log")
    if os.path.exists(cham_log):
        with open(cham_log) as f:
            # nn_bidir_kernel<DIM, NORM>: DIM 3 is the D = 3 instance, 0 any D.
            cham_inst = kernel_instances(f.read(), "nn_bidir_kernel")
        print("  nn_bidir_kernel instances <DIM,NORM> (registers, spill bytes): "
              + " ".join(f"<{k[0]},{k[1]}>:{regs}r{f'+{spill}s' if spill else ''}"
                         for k, (regs, spill) in sorted(cham_inst.items())))
        spilled = [k for k, (_, s) in cham_inst.items() if k[0] == 3 and s]
        require(len(cham_inst) == 4 and not spilled,
                f"nn_bidir_kernel instances {sorted(cham_inst)}; D=3 spills: {spilled}")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {gpu_line()}")

    stats = {k: {"err": 0.0} for k in ("knn", "chamfer", "rows", "k1", "ball",
                                       "fps_batched", "fps_resident",
                                       "fps_streaming")}

    def note_err(key, err):
        stats[key]["err"] = max(stats[key]["err"], float(err))

    def check_chamfer(x, y, l1, l2, norm, what):
        """The chamfer NN kernel against its plain twin: distances and
        indices equal in both directions. Returns the kernel's output."""
        outk = kc.chamfer_nn_cuda(x, y, l1, l2, norm)
        outp = kc.chamfer_nn_plain(x, y, l1, l2, norm)
        torch.cuda.synchronize()
        for a, b in ((outk[0], outp[0]), (outk[2], outp[2])):
            fin = torch.isfinite(a) & torch.isfinite(b)
            note_err("chamfer", (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0)
            require(torch.equal(a, b), f"{what}: dists")
        require(torch.equal(outk[1], outp[1]) and torch.equal(outk[3], outp[3]),
                f"{what}: idx")
        return outk

    # ---------------- phase 2: each kernel against its twin ----------------
    lengths1 = T(np.array([700, 333, 700, 0]), torch.int64)
    lengths2 = T(np.array([900, 50, 0, 900]), torch.int64)
    for D in (3, 16):
        p1 = T(grid_points(rng, (4, 700, D)))
        p2 = T(grid_points(rng, (4, 900, D)))
        for norm in (1, 2):
            for K in (1, 8, 16, 64, 100):
                dk, ik = kk.knn_topk_cuda(p1, p2, lengths2, K, norm)
                dp, ip = kk.knn_topk_plain(p1, p2, lengths2, K, norm)
                torch.cuda.synchronize()
                dk, ik = _apply_pad_conventions(dk, ik, lengths1, lengths2, K, 700)
                dp, ip = _apply_pad_conventions(dp, ip, lengths1, lengths2, K, 700)
                note_err("knn", (dk - dp).abs().max().item())
                require(torch.equal(dk, dp), f"knn D={D} norm={norm} K={K}: dists")
                require(torch.equal(ik, ip), f"knn D={D} norm={norm} K={K}: idx")
            # Every launch plan at shapes that cross the kernel's boundaries:
            # P1 = 1,337 is no multiple of the queries a block covers, P2 =
            # 2,061 none of a tile or a group, and lengths2 ends mid-tile
            # (1,030 and 519: 2 and 7 past a tile of 512 or 256, mid-group)
            # and at 0.
            bp1 = T(grid_points(rng, (4, 1337, D)))
            bp2 = T(grid_points(rng, (4, 2061, D)))
            bl1 = T(np.array([1337, 1337, 1000, 1337]), torch.int64)
            bl2 = T(np.array([2061, 1030, 519, 0]), torch.int64)
            for K in (1, 8, 16, 64, 100):
                dp, ip = _apply_pad_conventions(*kk.knn_topk_plain(bp1, bp2, bl2, K, norm),
                                                bl1, bl2, K, 1337)
                for plan in kk.card_plans(bp1, bp2, K, norm)[1]:
                    dk, ik = _apply_pad_conventions(
                        *kk.knn_topk_cuda(bp1, bp2, bl2, K, norm, _plan=plan),
                        bl1, bl2, K, 1337)
                    what = f"knn boundaries D={D} norm={norm} K={K} {kk.plan_name(plan)}"
                    note_err("knn", (dk - dp).abs().max().item())
                    require(torch.equal(dk, dp), f"{what}: dists")
                    require(torch.equal(ik, ip), f"{what}: idx")
            # Two sides of 2,500 points span several blocks in each direction.
            for x, y, l1, l2 in (
                (p1, p2, lengths1, lengths2),
                (T(grid_points(rng, (2, 2500, D))), T(grid_points(rng, (2, 2600, D))),
                 T(np.array([2500, 1777]), torch.int64),
                 T(np.array([2300, 2600]), torch.int64)),
            ):
                check_chamfer(x, y, l1, l2, norm, f"chamfer_nn D={D} norm={norm}")
    # The chamfer kernel's D = 3 instance at the edges of its sub-tiles (128
    # points) and chunks (1,024): P1 and P2 in {1, 127, 129, 1,023, 1,025,
    # 2,049}; per pair of clouds full lengths, a length of 1, a length that
    # ends mid-sub-tile, or 0; grid clouds (exact ties everywhere) and
    # Gaussian clouds where a tenth of the points copy others; both norms.
    # The sweep draws from its own generator, so the main paths' inputs do
    # not depend on it.
    erng = np.random.default_rng(args.seed + 1)

    def dup_points(N, P):
        a = erng.normal(size=(N, P, 3)).astype(np.float32)
        k = P // 10
        for i in range(N):
            a[i, erng.choice(P, size=k, replace=False)] = a[i, erng.integers(0, P, size=k)]
        return a

    def edge_lengths(P, order):
        mid = min(P, P // 2 + 5)  # 5 points into a sub-tile, unless P is tiny
        return T(np.array([P, 1, mid, 0, P])[order], torch.int64)

    edge_sizes = (1, 127, 129, 1023, 1025, 2049)
    for P1e in edge_sizes:
        for P2e in edge_sizes:
            l1 = edge_lengths(P1e, [0, 1, 2, 3, 4])
            l2 = edge_lengths(P2e, [0, 2, 1, 4, 3])
            for grid in (True, False):
                x = T(grid_points(erng, (5, P1e, 3)) if grid else dup_points(5, P1e))
                y = T(grid_points(erng, (5, P2e, 3)) if grid else dup_points(5, P2e))
                for norm in (1, 2):
                    check_chamfer(x, y, l1, l2, norm, f"chamfer_nn D=3 edges P1={P1e} "
                                  f"P2={P2e} grid={grid} norm={norm}")
    print(f"  chamfer_nn D=3 edges: {len(edge_sizes) ** 2 * 4} calls of 5 clouds "
          "equal to the plain twin (distances and indices)")
    # The D = 3 instance keeps minimum values and the sub-tile that holds
    # each, and rescans that sub-tile for the index. Tie-grid clouds of 1,100
    # and 2,300 points (no multiple of a sub-tile or a chunk; minima tied
    # across sub-tiles and chunks; one cloud's x side empty) and the chamfer
    # cell's shape, 32 x 16,384: all four outputs equal to the plain twin's,
    # both norms, each call one launch and N x (P1 + P2) rescanned points.
    from pytorch3d_pointops_tpu_torch import tracing

    rx, ry = T(grid_points(erng, (3, 1100, 3))), T(grid_points(erng, (3, 2300, 3)))
    rl1 = T(np.array([1100, 1029, 0]), torch.int64)
    rl2 = T(np.array([2300, 1153, 2277]), torch.int64)
    cx = T(1.5 * erng.normal(size=(32, 16384, 3)).astype(np.float32))
    cy = T(erng.normal(size=(32, 16384, 3)).astype(np.float32))
    cl = T(np.full(32, 16384), torch.int64)
    for norm in (1, 2):
        reset_launches()
        check_chamfer(rx, ry, rl1, rl2, norm, f"chamfer_nn D=3 tie grid 1,100 x 2,300 norm={norm}")
        check_chamfer(cx, cy, cl, cl, norm, f"chamfer_nn D=3 32 x 16,384 norm={norm}")
        counts = tracing.counts()
        got = (counts.get("launch.chamfer_nn_cuda"), counts.get("chamfer.rescan_points"))
        require(got == (2, 3 * (1100 + 2300) + 32 * 2 * 16384),
                f"chamfer_nn D=3 norm={norm}: (launches, rescanned points) {got}")
    print("  chamfer_nn D=3 rescan: tie grids 1,100 x 2,300 and 32 x 16,384 equal to the "
          "plain twin (both norms); launches and rescanned points counted")
    # Distance-0 ties at scale: 20,000 Gaussian queries against 20,000
    # points, K=16, where every fifth query is a copy of a candidate and a
    # tenth of the candidates copy another, under every plan (each Q, block
    # size and tile) the kernel takes at this shape.
    tie2 = rng.normal(size=(1, 20000, 3)).astype(np.float32)
    dup = rng.choice(20000, size=2000, replace=False)
    tie2[0, dup] = tie2[0, rng.integers(0, 20000, size=2000)]
    tie1 = rng.normal(size=(1, 20000, 3)).astype(np.float32)
    tie1[0, ::5] = tie2[0, rng.integers(0, 20000, size=4000)]
    tie1, tie2 = T(tie1), T(tie2)
    tie_len = T(np.array([20000]), torch.int64)
    dp, ip = kk.knn_topk_plain(tie1, tie2, tie_len, 16, 2)
    require(int((dp[..., 0] == 0).sum()) >= 4000, "tie cloud: too few distance-0 queries")
    chosen, plans = kk.card_plans(tie1, tie2, 16, 2)
    for plan in plans:
        dk, ik = kk.knn_topk_cuda(tie1, tie2, tie_len, 16, 2, _plan=plan)
        require(torch.equal(dk, dp) and torch.equal(ik, ip),
                f"knn tie cloud {kk.plan_name(plan)}: differs from plain")
    print(f"  knn tie cloud 20,000 x 20,000 K=16: bit-equal to plain under all "
          f"{len(plans)} plans (Q {sorted({p.queries for p in plans})}); the "
          f"wrapper picks {kk.plan_name(chosen)}")
    # The scatter: both entry points under the plan scatter_plan picks (the
    # bucket kernel alone at 64 and 600 rows, a one-pass partition, a
    # two-pass one past 2^21 rows; 6, 11 and 33 channels, a block taking
    # up to 8) on uniform targets, on targets where half the entries share
    # 16 rows and on targets all on one row, bit-equal run to run and to the
    # plain twin on CPU copies (which sums each row in entry order, as the
    # kernels do), and within TOL of the plain twin on the card (float
    # atomics) where no row is long; then one skewed input under every
    # bucket size the partition can take, from one row a bucket (the
    # partition a full sort of the keys, in two passes) to 2^11 rows. A
    # partition that lost, doubled or reordered an entry within its row
    # would change a sum's bits.
    def targets(N, E, P2, kind):
        if kind == "one row":
            return np.full((N, E), P2 // 2, dtype=np.int64)
        idx = rng.integers(-1, P2, size=(N, E))
        if kind == "hub":
            hubs = rng.integers(0, P2, size=16)
            idx = np.where(rng.uniform(size=(N, E)) < 0.5, rng.choice(hubs, size=(N, E)),
                           idx)
        return idx

    for N, E, P2, C, kinds in (
        (3, 4097, 1000, 3, ("uniform", "hub")), (1, 777, 64, 6, ("uniform", "hub")),
        (2, 999, 300, 11, ("uniform", "hub", "one row")),
        (2, 3000, 1000, 3, ("uniform", "hub")), (2, 8000, 800, 3, ("uniform", "one row")),
        (1, 16384, 2048, 8, ("uniform", "hub")), (1, 20000, 300, 33, ("uniform", "hub")),
        (4, 50000, 25000, 3, ("uniform", "hub", "one row")),
        (5, 200000, 1_000_000, 3, ("uniform", "hub")),
        (1, 300000, 2**22 + 5, 2, ("uniform", "hub")),
    ):
        for kind in kinds:
            idx = T(targets(N, E, P2, kind), torch.int64)
            contrib = T(rng.normal(size=(N, E, C)).astype(np.float32))
            what = f"{N}x{E} P2={P2} C={C} {kind} {ks.scatter_plan(N, E, P2, C)}"
            for key, wrapper in (("rows", ks.scatter_add_rows), ("k1", ks.scatter_add_k1)):
                out1 = hold_scatter(wrapper, idx, contrib, P2, f"scatter {key} {what}")
                if kind == "uniform":
                    err = (out1 - ks.scatter_add_plain(idx, contrib, P2)).abs().max().item()
                    note_err(key, err)
                    require(err <= TOL, f"scatter {key} {what}: err {err}")
    skew = T(targets(1, 300000, 100000, "uniform"), torch.int64)
    skew[0, ::2] = 7
    skew_c = torch.randn((1, 300000, 3), device=dev)
    ref = hold_scatter(ks.scatter_add_rows, skew, skew_c, 100000, "skewed scatter")
    for shift in range(ks._MAX_BUCKET_BITS + 1):
        digit_bits = 17 - shift
        passes = -(-digit_bits // 11)
        plan = ks.Plan(shift, passes, -(-digit_bits // passes), 3)
        require(torch.equal(ks._launch(skew, skew_c, 100000, plan=plan), ref),
                f"skewed scatter under {plan}: differs from the picked plan")

    # Ball query: ragged lengths on both sides, one cloud fully masked; a
    # 1/8 grid whose radius (0.25 at D=3, 0.75 at D=16) squares exactly to
    # pair distances, so boundary points are real; random points otherwise.
    bl1 = T(np.array([300, 120, 0, 300]), torch.int64)
    bl2 = T(np.array([2000, 700, 2000, 0]), torch.int64)
    for D in (3, 16):
        for grid in (True, False):
            if grid:
                q, r = grid_points(rng, (4, 300, D)), (0.25 if D == 3 else 0.75)
                ref_pts = grid_points(rng, (4, 2000, D))
            else:
                q = rng.uniform(-0.5, 0.5, size=(4, 300, D)).astype(np.float32)
                ref_pts = rng.uniform(-0.5, 0.5, size=(4, 2000, D)).astype(np.float32)
                r = 0.2 if D == 3 else 1.0
            q, ref_pts, r2 = T(q), T(ref_pts), kb.squared_radius(r)
            for K in (1, 32, 100, 500):
                dk, ik = kb.ball_query_cuda(q, ref_pts, bl1, bl2, K, r2)
                dp, ip = kb.ball_query_plain(q, ref_pts, bl1, bl2, K, r2)
                torch.cuda.synchronize()
                err = (dk - dp).abs().max().item()
                note_err("ball", err)
                what = f"ball_query D={D} grid={grid} K={K}"
                require(torch.equal(ik, ip), f"{what}: idx")
                require(err <= TOL, f"{what}: err {err}")
                require((ik >= 0).any(), f"{what}: no point in any ball")
    # Ball query at the edges of the warp-per-query design (csrc/ball_query.cu):
    # lengths2 of 31, 32 and 33 (around one ballot) and one past a staged
    # tile, 37 queries (no multiple of a block's 16), K around a ballot and
    # past every length; clouds whose points all coincide (every candidate
    # a hit, so the K-th hit falls mid-ballot) and grid clouds; D = 3, 5
    # (the D <= 8 instance) and 16.
    for D in (3, 5, 16):
        tile = 12288 // D  # csrc/ball_query.cu kTileFloats / D
        P1e, P2e = 37, tile + 1
        el1 = T(np.array([37, 20, 0, 37]), torch.int64)
        el2 = T(np.array([31, 32, 33, tile + 1]), torch.int64)
        for dup in (True, False):
            if dup:
                centre = grid_points(erng, (4, 1, D))
                ref_pts = np.repeat(centre, P2e, axis=1)
                q = np.repeat(centre, P1e, axis=1)
                q[:, 1::2] += np.float32(1 / 8)  # half the queries one step away
            else:
                q, ref_pts = grid_points(erng, (4, P1e, D)), grid_points(erng, (4, P2e, D))
            q, ref_pts = T(q), T(ref_pts)
            r2 = kb.squared_radius(0.25 if D == 3 else 0.75)
            for K in (1, 31, 32, 33, 500):
                dk, ik = kb.ball_query_cuda(q, ref_pts, el1, el2, K, r2)
                dp, ip = kb.ball_query_plain(q, ref_pts, el1, el2, K, r2)
                torch.cuda.synchronize()
                err = (dk - dp).abs().max().item()
                note_err("ball", err)
                what = f"ball_query edges D={D} dup={dup} K={K}"
                require(torch.equal(ik, ip), f"{what}: idx")
                require(err <= TOL, f"{what}: err {err}")
                if dup:
                    require(bool((ik[0, 0, :min(K, 31)] >= 0).all()), f"{what}: not all hits")
    print("  ball_query edges: lengths2 31/32/33/tile+1, 37 queries, K in {1, 31, 32, "
          "33, 500}, D in {3, 5, 16}: idx equal to the plain twin")
    # FPS: every entry point called directly. Ragged lengths with a 0, K
    # past the length, explicit starts; on the grid (3^D distinct points at
    # most, 27 at D=3) K=100 runs past the distinct points into all-zero
    # rounds. The grid kernels run at two sizes spanning many blocks.
    for D in (3, 16):
        for grid in (True, False):
            for N, P in ((5, 3000), (2, 200_000)):
                gen_pts = (rng.integers(0, 3, size=(N, P, D)).astype(np.float32) / 8
                           if grid else rng.normal(size=(N, P, D)).astype(np.float32))
                pts = T(gen_pts)
                lens = np.array([P, P // 2 + 1, 0, 17, P - 1])[:N]
                Ks = np.array([100, 50, 10, 40, 1])[:N]
                starts = np.array([5, P // 2, 0, 16, 0])[:N]
                lens, Ks, starts = (T(a, torch.int64) for a in (lens, Ks, starts))
                ref = kf.fps_plain(pts, lens, Ks, starts, 100)
                wrappers = [kf.fps_resident, kf.fps_streaming]
                if P <= kf.fps_limits(D, dev)[0]:
                    wrappers.insert(0, kf.fps_batched)
                for wrapper in wrappers:
                    out = wrapper(pts, lens, Ks, starts, 100)
                    torch.cuda.synchronize()
                    require(torch.equal(out, ref),
                            f"{wrapper.__name__} D={D} grid={grid} {N}x{P}: idx")
    # The block kernel (kernels/fps.py _block_plan) at each plan's capacity
    # T * SLOTS - 1, T * SLOTS and + 1 up to the block cap fps_limits(D)[0],
    # and at the cap, under every plan that holds the cloud: one cloud of P
    # points, and five with lengths P, 0, 1, 17 and P - 1, explicit starts
    # and per-cloud K; grid clouds (3^D distinct points: K=64 runs past them
    # at D=1 and 3) and Gaussian ones; D = 3, 16 and 1.
    block_edges = []
    for D in (3, 16, 1):
        cap = kf.fps_limits(D, dev)[0]
        plans = kf.BLOCK_PLANS[3 if D == 3 else 0]
        sizes = sorted({p for t, s in plans for p in (t * s - 1, t * s, t * s + 1)
                        if p <= cap} | {cap})
        for P in sizes:
            for N, grid in ((1, False), (5, True), (5, False)):
                gen_pts = (erng.integers(0, 3, size=(N, P, D)).astype(np.float32) / 8
                           if grid else erng.normal(size=(N, P, D)).astype(np.float32))
                pts = T(gen_pts)
                lens, Ks, starts = (T(np.array(a)[:N], torch.int64) for a in (
                    [P, 0, 1, 17, P - 1], [64, 5, 5, 30, 40], [P // 3, 0, 0, 16, P - 2]))
                ref = kf.fps_plain(pts, lens, Ks, starts, 64)
                for t, sl in plans:
                    if t * sl < P:
                        continue
                    plan = kf._block_plan(P, D)._replace(threads=t, slots=sl)
                    out = kf.fps_batched(pts, lens, Ks, starts, 64, _plan=plan)
                    torch.cuda.synchronize()
                    require(torch.equal(out, ref), f"fps_batched D={D} {N}x{P} grid={grid} "
                            f"t{t}/s{sl}: idx")
        block_edges.append(f"D={D} P={sizes}")
    print(f"  fps block plans at their edges, every plan equal to fps_plain: "
          f"{'; '.join(block_edges)}")
    # The grid kernel's tiers (kernels/fps.py _grid_plan): one cloud at and
    # around the largest slice whose coordinates registers hold, the
    # resident and the register capacities, D=3 (the register cap at D=1
    # for the any-D instances' global tier), one cloud past the resident
    # cap at D=16, and 6M points.
    sms, smem = kf._card(0)
    fps_tiers = []
    res3, reg3 = (sms * c for c in kf._grid_caps(3, smem))
    coords3 = sms * max(t * s for t, s in kf.REG_PLANS)
    res16 = sms * kf._grid_caps(16, smem)[0]
    reg1 = sms * kf._grid_caps(1, smem)[1]
    for D, P, K in ((3, coords3, 32), (3, coords3 + 1, 32),
                    (3, res3 - 1, 32), (3, res3, 32), (3, res3 + 1, 32),
                    (3, reg3 - 1, 32), (3, reg3, 32), (3, reg3 + 1, 32),
                    (3, 6_000_000, 64), (16, res16 + 50_000, 32), (1, reg1 + 1, 32)):
        gen = torch.Generator(device=dev).manual_seed(args.seed * 7919 + P)
        pts = torch.randn((1, P, D), generator=gen, device=dev)
        lens, Ks, starts = (T(np.array([a]), torch.int64) for a in (P, K, P // 3))
        ref = kf.fps_plain(pts, lens, Ks, starts, K)
        plan = kf.card_plan(pts)
        runs = [(kf.fps_streaming, plan)]
        if plan.tier == "resident":
            runs.append((kf.fps_resident, plan))
        else:
            try:
                kf.fps_resident(pts, lens, Ks, starts, K)
                require(False, f"fps_resident took {P} points at D={D}")
            except ValueError:
                pass
        for wrapper, pl in runs:
            out = wrapper(pts, lens, Ks, starts, K, _plan=pl)
            require(torch.equal(out, ref),
                    f"{wrapper.__name__} D={D} P={P} {kf.plan_name(pl)}: idx")
        fps_tiers.append(f"D={D} P={P}: {plan.tier} t{plan.threads}/s{plan.slots}")
    print(f"  fps grid tiers, every run equal to fps_plain: {'; '.join(fps_tiers)}")
    # The cluster path (kernels/fps.py _cluster_plan): every instance forced
    # at its capacity (C x threads x 16 points, up to 40,000) on seven
    # clouds of lengths P, 0, 1, 2, 3, P - 1 and threads x C + 1, per-cloud
    # K, explicit starts, grid and Gaussian clouds; then, by route: one
    # cloud of 80,000 points, 12 clouds of 160,000 (more clusters than the
    # card holds at once: waves), 12 of 80,000 with clusters of 16 forced
    # (waves), two clouds at the cluster cap and two past it (the grid
    # kernel), and one cloud at the one-cloud limit and one past it.
    from pytorch3d_pointops_tpu_torch.ops.fps import ONE_CLOUD_CLUSTER_MAX, route

    cluster_cap = kf.cluster_limit(3, dev)
    active = kf._cluster_card(0)
    for t, sl, c in kf.CLUSTER_PLANS:
        P = min(t * sl * c, 40_000)
        plan = kf.ClusterPlan(c, t, sl, -(-P // c), 1)
        for grid in (True, False):
            gen_pts = (erng.integers(0, 3, size=(7, P, 3)).astype(np.float32) / 8
                       if grid else erng.normal(size=(7, P, 3)).astype(np.float32))
            pts = T(gen_pts)
            lens, Ks, starts = (T(np.array(a), torch.int64) for a in (
                [P, 0, 1, 2, 3, P - 1, min(P, t * c + 1)], [300, 5, 5, 5, 7, 150, 300],
                [3, 0, 0, 1, 2, P - 2, 5]))
            out = kf.fps_clustered(pts, lens, Ks, starts, 300, _plan=plan)
            require(torch.equal(out, kf.fps_plain(pts, lens, Ks, starts, 300)),
                    f"fps_clustered {kf.cluster_plan_name(plan)} grid={grid}: idx")
    cluster_cases = []
    for N, P, K, want, forced in (
            (1, 80_000, 1024, "fps_clustered", None),
            (12, 160_000, 256, "fps_clustered", None),
            (12, 80_000, 512, "fps_clustered", kf.ClusterPlan(16, 512, 16, 5000, 2)),
            (2, cluster_cap, 256, "fps_clustered", None),
            (2, cluster_cap + 1, 256, "fps_resident", None),
            (1, ONE_CLOUD_CLUSTER_MAX, 256, "fps_clustered", None),
            (1, ONE_CLOUD_CLUSTER_MAX + 1, 256, "fps_resident", None)):
        gen = torch.Generator(device=dev).manual_seed(args.seed * 7919 + N * P)
        pts = torch.randn((N, P, 3), generator=gen, device=dev)
        lens = T(np.array([P - 13 * i for i in range(N)]), torch.int64)
        Ks = T(np.array([K - i for i in range(N)]), torch.int64)
        starts = T(np.array([(P // 3 + i) % (P - 13 * i) for i in range(N)]), torch.int64)
        wrapper = route(pts)
        require(wrapper.__name__ == want, f"route({N} x {P}) is {wrapper.__name__}, not {want}")
        plan = forced or (kf.card_cluster_plan(pts) if want == "fps_clustered" else None)
        out = wrapper(pts, lens, Ks, starts, K, _plan=plan)
        require(torch.equal(out, kf.fps_plain(pts, lens, Ks, starts, K)),
                f"{want} {N} x {P} K={K}: idx")
        cluster_cases.append(f"{N}x{P} {want}" + (f" ({kf.cluster_plan_name(plan)})"
                                                  if plan else ""))
    print(f"  fps cluster instances at their capacity and directed cases, equal to "
          f"fps_plain (clusters held at once {json.dumps({f'{t}/{sl}/{c}': n for (t, sl, c), n in active.items()})}): "
          f"{'; '.join(cluster_cases)}")
    # The Point Transformer cell's shapes: its model at published widths
    # (seeded weights, training mode) on four generated rooms of the cell's
    # lengths; its own generator, so the other phases' inputs do not move.
    from pytorch3d_pointops_tpu_torch.models import PointTransformerSeg

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        pt_model = PointTransformerSeg().to(dev).train()
    pt_xyz, pt_rgb, pt_labels = room_clouds(np.random.default_rng(args.seed + 2), PT_LENGTHS,
                                            max(PT_LENGTHS))
    pt_xyz, pt_rgb, pt_labels = T(pt_xyz), T(pt_rgb), T(pt_labels, torch.int64)
    pt_kernels(pt_model, pt_xyz, PT_LENGTHS, note_err)
    print("phase 2: every kernel agrees with its plain twin "
          f"(max abs err {json.dumps({k: v['err'] for k, v in stats.items()})})")

    # ---------------- phase 3: the main path at full size ----------------
    # Config 3: chamfer fwd+bwd with normals and colors, batch 16 x 10k.
    N3, P3 = 16, 10000
    len_x = rng.integers(9000, P3 + 1, size=N3)
    len_y = rng.integers(9000, P3 + 1, size=N3)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)

    def feats():
        return {
            "normals": unit(rng.normal(size=(N3, P3, 3))),
            "colors": rng.uniform(size=(N3, P3, 3)).astype(np.float32),
        }
    tgt = ppt.pointclouds_from_numpy(
        rng.normal(size=(N3, P3, 3)).astype(np.float32), len_y, feats(), device=dev
    )
    src0 = ppt.pointclouds_from_numpy(
        (1.5 * rng.normal(size=(N3, P3, 3))).astype(np.float32), len_x, feats(),
        device=dev,
    )
    names = ["normals", "colors"]

    def cham_step(p):
        src = src0.update_padded(p)
        loss, lf = ppt.chamfer_distance(
            src, tgt, feature_names=names, point_reduction="mean",
            batch_reduction="mean",
        )
        (loss + lf["normals"] + lf["colors"]).backward()
        return loss, lf

    # Config 1: 2 clouds of 1000/800 points against the same shifted by 0.05.
    c1 = [rng.normal(size=(1000, 3)).astype(np.float32),
          rng.normal(size=(800, 3)).astype(np.float32)]
    pc1 = ppt.Pointclouds([T(c) for c in c1])
    pc2 = ppt.Pointclouds([T(c + 0.05) for c in c1])

    def knn_step(q, r, l1, l2, K):
        q = q.detach().requires_grad_(True)
        r = r.detach().requires_grad_(True)
        out = ppt.knn_points(q, r, l1, l2, K=K)
        out.dists.sum().backward()
        return out, q.grad, r.grad

    # North star: one cloud of 100k queries against 100k points, K=16.
    ns_p1 = T(rng.normal(size=(1, 100000, 3)).astype(np.float32))
    ns_p2 = T(rng.normal(size=(1, 100000, 3)).astype(np.float32))

    counters = ("knn_topk_cuda", "chamfer_nn_cuda", "scatter_add_rows", "scatter_add_k1")
    reset_launches()
    # -- the main path: nothing but what a user would call --
    p = src0.points_padded().clone().requires_grad_(True)
    lr = 0.2 * N3 * P3
    losses, step_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = cham_step(p)
        with torch.no_grad():
            p -= lr * p.grad
        p.grad = None
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    c1_ms = wall_ms(lambda: knn_step(pc1.points_padded(), pc2.points_padded(),
                                     pc1.num_points_per_cloud(),
                                     pc2.num_points_per_cloud(), 8), reps=10)
    ns_ms = wall_ms(lambda: knn_step(ns_p1, ns_p2, None, None, 16), reps=3)
    launches = launch_counts(counters)
    # -- end of the main path --
    print(f"phase 3: main-path launches {json.dumps(launches)}")
    require(all(v > 0 for v in launches.values()), "a kernel of the path never ran")
    print(f"  config 3 chamfer losses {losses}; step ms "
          f"{[round(t, 3) for t in step_ms]}, median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], "loss did not fall")
    print(f"  config 1 knn K=8 fwd+bwd median {c1_ms:.3f} ms")
    print(f"  north-star knn 100k x 100k K=16 fwd+bwd median {ns_ms:.3f} ms")
    print("  knn launch plans: config 1 "
          f"{kk.plan_name(kk.card_plans(pc1.points_padded(), pc2.points_padded(), 8, 2)[0])}"
          f", north star {kk.plan_name(kk.card_plans(ns_p1, ns_p2, 16, 2)[0])}")

    @contextlib.contextmanager
    def plain_path():
        """Route the ops through the plain twins, on the card."""
        saved = (kk.knn_topk, kc.chamfer_nn_bidirectional, ks.scatter_add_rows,
                 ks.scatter_add_k1, kb.ball_query_points, kf.fps_batched,
                 kf.fps_resident, kf.fps_streaming)
        kk.knn_topk = kk.knn_topk_plain
        kc.chamfer_nn_bidirectional = kc.chamfer_nn_plain
        ks.scatter_add_rows = ks.scatter_add_k1 = ks.scatter_add_plain
        kb.ball_query_points = kb.ball_query_plain
        kf.fps_batched = kf.fps_resident = kf.fps_streaming = kf.fps_plain
        try:
            yield
        finally:
            (kk.knn_topk, kc.chamfer_nn_bidirectional, ks.scatter_add_rows,
             ks.scatter_add_k1, kb.ball_query_points, kf.fps_batched,
             kf.fps_resident, kf.fps_streaming) = saved

    # Config 3, one step against the plain path, and two bit-equal backwards.
    # The gradients are held relative to their largest entry: with mean/mean
    # over 16 x ~9,500 points each entry is of order 1e-6.
    grads = []
    for _ in range(2):
        q = p.detach().clone().requires_grad_(True)
        loss_k, lf_k = cham_step(q)
        grads.append(q.grad)
    require(torch.equal(grads[0], grads[1]), "config 3 backward not bit-equal")
    q = p.detach().clone().requires_grad_(True)
    with plain_path():
        loss_p, lf_p = cham_step(q)

    def rel_err(a, b):
        return abs(a.item() - b.item()) / abs(b.item())

    rels = {"loss": rel_err(loss_k, loss_p),
            **{n: rel_err(lf_k[n], lf_p[n]) for n in names}}
    gscale = q.grad.abs().max().item()
    gerr = (grads[0] - q.grad).abs().max().item()
    print(f"  config 3 vs plain: rel err {json.dumps(rels)}, grad max abs err "
          f"{gerr:.3g} (largest entry {gscale:.3g}); two backwards bit-equal")
    require(all(r <= TOL for r in rels.values()),
            f"config 3 losses disagree with the plain path: {rels}")
    require(gscale > 0 and gerr <= TOL * gscale,
            f"config 3 gradients disagree with the plain path: {gerr} vs {gscale}")

    # Config 1 and a 4,096-query subset of the north star against the plain path.
    for label, args_ in (
        ("config 1", (pc1.points_padded(), pc2.points_padded(),
                      pc1.num_points_per_cloud(), pc2.num_points_per_cloud(), 8)),
        ("north-star subset", (ns_p1[:, :4096], ns_p2, None, None, 16)),
    ):
        ok, gq, gr = knn_step(*args_)
        with plain_path():
            op, pq, pr = knn_step(*args_)
        torch.cuda.synchronize()
        require(torch.equal(ok.idx, op.idx), f"{label}: idx differ from plain")
        derr = (ok.dists - op.dists).abs().max().item()
        require(derr <= TOL, f"{label}: dists err {derr}")
        require(torch.allclose(gq, pq, rtol=TOL, atol=TOL)
                and torch.allclose(gr, pr, rtol=TOL, atol=TOL),
                f"{label}: grads differ from plain")
        note_err("knn", derr)
        print(f"  {label} vs plain: idx equal, dists max abs err {derr:.3g}, "
              f"grads max abs err {(gq - pq).abs().max().item():.3g} / "
              f"{(gr - pr).abs().max().item():.3g}")
    ns_sub = kk.knn_topk_cuda(ns_p1, ns_p2, T(np.array([100000]), torch.int64), 16, 2)
    sub_ref = kk.knn_topk_plain(ns_p1[:, :4096], ns_p2,
                                T(np.array([100000]), torch.int64), 16, 2)
    require(torch.equal(ns_sub[1][:, :4096], sub_ref[1]),
            "north-star full-run idx differ from plain on the subset")

    # ---------------- phase 3b: config 2, PointNet++ grouping ----------------
    def unit_ball(n):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (d * rng.uniform(size=(n, 1)) ** (1 / 3)).astype(np.float32)

    N2, P2c, S2, K2, R2 = 32, 4096, 512, 32, 0.2
    pts2 = T(unit_ball(N2 * P2c).reshape(N2, P2c, 3))
    len2 = T(rng.integers(3500, P2c + 1, size=N2), torch.int64)
    big1 = T(unit_ball(1_000_000)[None])
    big4 = T(unit_ball(4_000_000)[None])

    def group_step(x):
        x = x.detach().requires_grad_(True)
        centroids, fidx = ppt.sample_farthest_points(x, len2, K=S2)
        g = ppt.ball_query(centroids, x, lengths2=len2, K=K2, radius=R2)
        local = g.knn - centroids[:, :, None]
        loss = local.square().sum() + g.dists.sum()
        loss.backward()
        return loss, fidx, g, x.grad

    counters2 = ("fps_batched", "fps_resident", "fps_streaming", "ball_query_cuda",
                 "scatter_add_rows")
    reset_launches()
    # -- the config 2 main path: nothing but what a user would call --
    group_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss2, fidx2, g2, grad2 = group_step(pts2)
        torch.cuda.synchronize()
        group_ms.append((time.perf_counter() - t0) * 1e3)
    big_ms = {}
    big_idx = {}
    for label, cloud, K in (("1M", big1, 1024), ("4M", big4, 512)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, big_idx[label] = ppt.sample_farthest_points(cloud, K=K)
        torch.cuda.synchronize()
        big_ms[label] = (time.perf_counter() - t0) * 1e3
    launches2 = launch_counts(counters2)
    # -- end of the config 2 main path --
    print(f"phase 3b: config 2 launches {json.dumps(launches2)}")
    require(all(v > 0 for v in launches2.values()),
            "a kernel of the config 2 path never ran")
    print(f"  config 2 step ms {[round(t, 3) for t in group_ms]}, median after "
          f"warm-up {statistics.median(group_ms[1:]):.3f}; loss {loss2.item():.6g}; "
          f"balls filled {(g2.idx >= 0).float().mean().item():.4f} of K={K2}")
    print(f"  large-cloud FPS ms (one call each, first call): {json.dumps(big_ms)}")
    require(torch.isfinite(grad2).all() and grad2.abs().max() > 0,
            "config 2 gradient not finite or all zero")

    # One config 2 step against the plain path, and two bit-equal backwards.
    loss2b, fidx2b, g2b, grad2b = group_step(pts2)
    require(torch.equal(grad2, grad2b), "config 2 backward not bit-equal")
    with plain_path():
        loss2p, fidx2p, g2p, grad2p = group_step(pts2)
    require(torch.equal(fidx2, fidx2p), "config 2 FPS idx differ from plain")
    require(torch.equal(g2.idx, g2p.idx), "config 2 ball idx differ from plain")
    rel2 = rel_err(loss2, loss2p)
    gscale2 = grad2p.abs().max().item()
    gerr2 = (grad2 - grad2p).abs().max().item()
    print(f"  config 2 vs plain: FPS and ball idx equal, loss rel err {rel2:.3g}, "
          f"grad max abs err {gerr2:.3g} (largest entry {gscale2:.3g}); two "
          "backwards bit-equal")
    require(rel2 <= TOL, f"config 2 loss disagrees with the plain path: {rel2}")
    require(gerr2 <= TOL * gscale2,
            f"config 2 gradients disagree with the plain path: {gerr2} vs {gscale2}")
    # Config 2's backward scatters, recorded in one more step, config 1's
    # and its first cloud's alone: each bit-equal to the CPU twin and run to
    # run, with its longest row (one thread's serial adds), its skipped
    # entries, its time and its device operations (at most 4; 1 for the one
    # cloud, whose 8,000 entries and 800 rows take the bucket kernel alone,
    # while config 1's 16,000 entries take the partition). Beside them, the
    # ball gather's index as it was before its padded slots were skipped:
    # every padded slot sent to row 0 of its cloud.
    with recorded_scatters() as calls:
        group_step(pts2)
    require(len(calls) == 3, f"config 2 backward made {len(calls)} scatters, not 3")
    with recorded_scatters() as calls1:
        knn_step(pc1.points_padded(), pc2.points_padded(), pc1.num_points_per_cloud(),
                 pc2.num_points_per_cloud(), 8)
    require(len(calls1) == 1, f"config 1 backward made {len(calls1)} scatters, not 1")
    idx1, contrib1, P21 = calls1[0]
    for label, (idx, contrib, P2) in (
        *((f"config 2 backward scatter {i}", c) for i, c in enumerate(calls)),
        ("config 1 backward scatter", calls1[0]),
        ("config 1 backward scatter, first cloud", (idx1[:1], contrib1[:1], P21)),
    ):
        hold_scatter(ks.scatter_add_rows, idx, contrib, P2, label)
        line, steps = scatter_line(idx, contrib, P2)
        print(f"  {label}: {line}")
        require(len(steps) <= (1 if label.endswith("first cloud") else 4),
                f"{label}: {len(steps)} device operations")
    hub_idx = torch.where(g2.idx < 0, 0, g2.idx).reshape(N2, -1)
    hub_c = torch.randn((*hub_idx.shape, 3), device=dev)
    hold_scatter(ks.scatter_add_rows, hub_idx, hub_c, P2c, "config 2 hub scatter")
    print(f"  config 2 ball gather with padded slots sent to row 0: "
          f"{int((g2.idx < 0).sum())} padded slots; {scatter_line(hub_idx, hub_c, P2c)[0]}")
    for label, cloud, K in (("1M", big1, 1024), ("4M", big4, 512)):
        one = T(np.array([cloud.shape[1]]), torch.int64)
        ref = kf.fps_plain(cloud, one, T(np.array([K]), torch.int64),
                           T(np.array([0]), torch.int64), K)
        require(torch.equal(big_idx[label], ref), f"FPS {label}: idx differ from plain")
    print("  large-cloud FPS vs plain: idx equal (1M K=1024, 4M K=512)")

    # ---------------- phase 3c: the Point Transformer's step ----------------
    phase3c(pt_model, pt_xyz, pt_rgb, pt_labels, PT_LENGTHS, plain_path)
    del pt_model, pt_xyz, pt_rgb, pt_labels

    # ---------------- phase 4: Morton sorting, config 4, the last ops ----------------
    cases = phase4(args, T, ns_p1, ns_p2, pc1, pc2, tie1, tie2, knn_step, plain_path,
                   note_err)

    # ---------------- phase 5: kth-bound seeding ----------------
    phase5(cases, plain_path, note_err)

    # ---------------- phase 6: the ring layer ----------------
    ring_launches, ring_times, ring_inputs = phase6(T, rng, plain_path)

    # ---------------- phase 7: the ring across processes ----------------
    procs_launches = phase7(ring_inputs, ring_times, dev)

    # ---------------- phases 8 and 9: the examples, the seeded sweep ----------------
    examples_launches = phase8(plain_path, WRAPPERS, dev)
    sweep_cases = phase9(WRAPPERS, dev)

    # ---------------- kernel times at the main path's shapes ----------------
    records = []
    full = T(np.array([100000]), torch.int64)
    ms = cuda_ms(lambda: kk.knn_topk_cuda(ns_p1, ns_p2, full, 16, 2), reps=5)
    plain_ms = cuda_ms(lambda: kk.knn_topk_plain(ns_p1, ns_p2, full, 16, 2),
                       reps=1, warmup=0)
    pairs, D = 100000 * 100000, 3
    b = bound(4 * (2 * 100000 * D) + 8 + 100000 * 16 * (4 + 8), pairs * 3 * D)
    records.append(dict(
        name="knn_topk", route="cuda",
        source="pytorch3d_pointops_tpu_torch/csrc/knn.cu",
        replaces="pytorch3d_pointops_tpu/kernels/knn_pallas.py:1120",
        launches=launches["knn_topk_cuda"], max_abs_err=stats["knn"]["err"],
        ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
    ))

    x3 = src0.points_padded()
    y3 = tgt.points_padded()
    l3x, l3y = src0.num_points_per_cloud(), tgt.num_points_per_cloud()
    check_chamfer(x3, y3, l3x, l3y, 1, "chamfer_nn config 3 norm=1")
    outk = check_chamfer(x3, y3, l3x, l3y, 2, "chamfer_nn config 3 norm=2")
    ms = cuda_ms(lambda: kc.chamfer_nn_cuda(x3, y3, l3x, l3y, 2), reps=10)
    plain_ms = cuda_ms(lambda: kc.chamfer_nn_plain(x3, y3, l3x, l3y, 2), reps=3)
    pairs = int((l3x * l3y).sum())
    b = bound(4 * 2 * N3 * P3 * 3 + 16 * 2 + 2 * N3 * P3 * (4 + 8), pairs * 3 * 3)
    records.append(dict(
        name="chamfer_nn_bidir", route="cuda",
        source="pytorch3d_pointops_tpu_torch/csrc/chamfer_nn.cu",
        replaces="pytorch3d_pointops_tpu/kernels/chamfer_pallas.py:254",
        launches=launches["chamfer_nn_cuda"], max_abs_err=stats["chamfer"]["err"],
        ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
    ))

    # The scatters take the main path's own indices: the north-star K=16
    # neighbours (grad_p2) and the config 3 x -> y nearest neighbours. Each
    # call is held bit-equal to the CPU twin and run to run, and also timed
    # step by step (CUDA events recorded between its launches); index_add_
    # is timed in both of its modes, non-deterministic (library_ms) and
    # under torch.use_deterministic_algorithms(True) (library_det_ms), one
    # call per pair of events, as the kernel's ms is.
    k1_idx = torch.where(torch.arange(P3, device=dev)[None] < l3x[:, None], outk[1], -1)

    def one_call(fn):
        return cuda_ms(fn, reps=10)

    for key, wrapper, idx, P2 in (
        ("rows", ks.scatter_add_rows, ns_sub[1].reshape(1, -1), 100000),
        ("k1", ks.scatter_add_k1, k1_idx, P3),
    ):
        N, E = idx.shape
        contrib = torch.randn((N, E, 3), device=dev)
        out1 = hold_scatter(wrapper, idx, contrib, P2,
                            f"scatter {key} at the main path's shape")
        err = (out1 - ks.scatter_add_plain(idx, contrib, P2)).abs().max().item()
        note_err(key, err)
        require(err <= TOL, f"scatter {key} at the main path's shape: err {err}")
        ms = cuda_ms(lambda: wrapper(idx, contrib, P2), reps=10)
        line, steps = scatter_line(idx, contrib, P2)
        print(f"  scatter_add_{key}: {line}")
        require(len(steps) <= 4, f"scatter {key}: {len(steps)} device operations")
        plain_ms = cuda_ms(lambda: ks.scatter_add_plain(idx, contrib, P2), reps=10)
        valid = int((idx >= 0).sum())
        b = bound(E * N * (8 + 4 * 3) + N * P2 * 3 * 4, valid * 3)
        records.append(dict(
            name=f"scatter_add_{key}", route="cuda",
            source="pytorch3d_pointops_tpu_torch/csrc/scatter.cu",
            replaces=("pytorch3d_pointops_tpu/kernels/scatter_pallas.py:199"
                      if key == "rows" else
                      "pytorch3d_pointops_tpu/kernels/chamfer_pallas.py:367"),
            launches=launches[wrapper.__name__], max_abs_err=stats[key]["err"],
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            library_ms=library_ms(idx, contrib, P2, False, timer=one_call),
            library_det_ms=library_ms(idx, contrib, P2, True, timer=one_call),
            steps_ms=steps,
        ))

    # A skewed input (one row receives 100,000 of 200,000 entries) and every
    # entry on one row, through both entry points: a long row is one
    # thread's serial adds out of shared memory.
    skew_idx = T(rng.integers(0, 100000, size=(1, 200000)), torch.int64)
    skew_idx[0, ::2] = 7
    skew_c = torch.randn((1, 200000, 3), device=dev)
    for label, idx in (("skewed scatter (100,000 of 200,000 entries on one of "
                        "100,000 rows)", skew_idx),
                       ("one-row scatter (200,000 entries on one of 100,000 rows)",
                        torch.full_like(skew_idx, 7))):
        for wrapper in (ks.scatter_add_rows, ks.scatter_add_k1):
            hold_scatter(wrapper, idx, skew_c, 100000, f"{label} {wrapper.__name__}")
        k1_ms = cuda_ms(lambda: ks.scatter_add_k1(idx, skew_c, 100000), reps=5)
        print(f"  {label}: {scatter_line(idx, skew_c, 100000, reps=5)[0]}; "
              f"scatter_add_k1 {k1_ms:.4f} ms")

    # Config 3's step with the source collapsed (every point at its cloud's
    # first point plus noise of 1e-6, as a decoder's first steps may give):
    # each direction's nearest neighbours crowd a few rows. Its K=1
    # scatters, recorded, beside the normal step's: bit-equal to the CPU
    # twin and run to run, longest row, time.
    x3c = x3[:, :1] + 1e-6 * torch.randn_like(x3)
    for label, pts in (("normal", x3), ("collapsed", x3c)):
        with recorded_scatters() as calls3:
            step3_ms = wall_ms(lambda: cham_step(pts.detach().clone().requires_grad_(True)),
                               reps=3)
        require(len(calls3) == 2 * 4, f"config 3 {label}: {len(calls3)} scatters")
        for i, (idx, contrib, P2) in enumerate(calls3[:2]):
            hold_scatter(ks.scatter_add_k1, idx, contrib, P2,
                         f"config 3 {label} step scatter {i}")
            print(f"  config 3 {label} step ({step3_ms:.3f} ms fwd+bwd) scatter_add_k1 "
                  f"{i}: {scatter_line(idx, contrib, P2)[0]}")

    # Ball query at the config 2 shape, on the main path's own centroids. The
    # bound counts the pairs each query must visit: up to its K-th hit, or
    # all of lengths2 when it has fewer.
    cent = ppt.masked_gather(pts2, fidx2).detach()
    l1c = T(np.full(N2, S2), torch.int64)
    r2c = kb.squared_radius(R2)
    dk, ik = kb.ball_query_cuda(cent, pts2, l1c, len2, K2, r2c)
    dp, ip = kb.ball_query_plain(cent, pts2, l1c, len2, K2, r2c)
    err = (dk - dp).abs().max().item()
    note_err("ball", err)
    require(torch.equal(ik, ip) and err <= TOL, f"ball_query config 2: err {err}")
    ms = cuda_ms(lambda: kb.ball_query_cuda(cent, pts2, l1c, len2, K2, r2c), reps=10)
    plain_ms = cuda_ms(lambda: kb.ball_query_plain(cent, pts2, l1c, len2, K2, r2c),
                       reps=3)
    visited = torch.where((ip >= 0).sum(-1) == K2, ip[..., -1] + 1, len2[:, None])
    pairs = int(visited.sum())
    b = bound(4 * 3 * (N2 * S2 + int(len2.sum())) + 2 * N2 * 8
              + N2 * S2 * K2 * (4 + 8), pairs * 3 * 3)
    records.append(dict(
        name="ball_query", route="cuda",
        source="pytorch3d_pointops_tpu_torch/csrc/ball_query.cu",
        replaces="pytorch3d_pointops_tpu/kernels/ball_query_pallas.py:207",
        launches=launches2["ball_query_cuda"], max_abs_err=stats["ball"]["err"],
        ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
    ))
    print(f"  ball_query config 2: {pairs} pairs to visit "
          f"({pairs / (N2 * S2):.1f} a query)")

    # FPS at the main path's shapes: config 2 on the block kernel, the 1M
    # and 4M clouds on the grid kernels. The K rounds run one after another;
    # the bound counts (3D+2) operations a point in every round.
    for name, wrapper, line, cloud, lens, K in (
        ("fps_batched", kf.fps_batched, 139, pts2, len2, S2),
        ("fps_resident", kf.fps_resident, 268, big1, None, 1024),
        ("fps_streaming", kf.fps_streaming, 474, big4, None, 512),
    ):
        N, P, D = cloud.shape
        lens = T(np.full(N, P), torch.int64) if lens is None else lens
        Ks = T(np.full(N, K), torch.int64)
        starts = T(np.zeros(N), torch.int64)
        fargs = (cloud, lens, Ks, starts, K)
        out = wrapper(*fargs)
        ref = kf.fps_plain(*fargs)
        require(torch.equal(out, ref), f"{name} at the main path's shape: idx")
        note_err(name, (out - ref).abs().max().item())
        ms = cuda_ms(lambda: wrapper(*fargs), reps=5)
        plain_ms = cuda_ms(lambda: kf.fps_plain(*fargs), reps=1, warmup=0)
        rounds = (torch.minimum(lens, Ks) - 1).clamp(min=0)
        b = bound(4 * D * int(lens.sum()) + 3 * N * 8 + N * K * 8,
                  int((rounds * lens).sum()) * (3 * D + 2))
        records.append(dict(
            name=name, route="cuda",
            source="pytorch3d_pointops_tpu_torch/csrc/fps.cu",
            replaces=f"pytorch3d_pointops_tpu/kernels/fps_pallas.py:{line}",
            launches=launches2[name], max_abs_err=stats[name]["err"],
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
        ))
    print(f"  fps_batched plan at config 2: {kf.block_plan_name(kf._block_plan(P2c, 3))}")
    # The fixed cost of a block round: 32 clouds of 512 points at K=512 (511
    # rounds; 32 points would allow 31, as k_n = min(K, length)). A D=3 plan
    # visits every slot whatever the length, so this is a round's cost under
    # the plan a cloud of up to 2,048 points takes. The latency is the time
    # beyond the same call at K=1 (no rounds: the host's part of a call
    # cancels), over 511.
    tiny_b = T(rng.normal(size=(32, 512, 3)).astype(np.float32))
    bl512 = T(np.full(32, 512), torch.int64)
    b0 = T(np.zeros(32), torch.int64)
    bargs = {k: (tiny_b, bl512, T(np.full(32, k), torch.int64), b0, k) for k in (1, 512)}
    require(torch.equal(kf.fps_batched(*bargs[512]), kf.fps_plain(*bargs[512])),
            "fps_batched on the tiny clouds: idx")
    block_ms = {k: cuda_ms(lambda: kf.fps_batched(*a), reps=20) for k, a in bargs.items()}
    block_round_us = (block_ms[512] - block_ms[1]) * 1e3 / 511
    print(f"  fps block round latency: {block_round_us:.3f} us a round (fps_batched "
          f"on 32 x 512 points: {block_ms[512]:.4f} ms at K=512, 511 rounds, against "
          f"{block_ms[1]:.4f} ms at K=1; {kf.block_plan_name(kf._block_plan(512, 3))})")
    # The fixed cost of a grid round: about 8 points a block, K=1024.
    tiny = T(rng.normal(size=(1, 8 * sms, 3)).astype(np.float32))
    targs = (tiny, T(np.array([8 * sms]), torch.int64),
             T(np.array([1024]), torch.int64), T(np.array([0]), torch.int64), 1024)
    require(torch.equal(kf.fps_resident(*targs), kf.fps_plain(*targs)),
            "fps_resident on the tiny cloud: idx")
    round_us = cuda_ms(lambda: kf.fps_resident(*targs), reps=10) * 1e3 / 1023
    print(f"  fps grid round latency: {round_us:.3f} us a round (one fps_resident "
          f"call over its 1023 rounds, 1 x {8 * sms} points, K=1024, "
          f"{kf.plan_name(kf.card_plan(tiny))})")
    print("  fps plans: 1M " + kf.plan_name(kf.card_plan(big1)) + "; 4M "
          + kf.plan_name(kf.card_plan(big4)))
    print("timed shapes: knn_topk 1 x 100000 x 100000 K=16 D=3; chamfer_nn_bidir "
          "16 x 10000 (ragged 9000-10000) D=3; scatter_add_rows E=1,600,000 "
          "into 100000 x 3; scatter_add_k1 E=16 x 10000 into 16 x 10000 x 3; "
          "ball_query 32 x 512 queries vs 32 x 4096 (ragged 3500-4096) K=32 "
          "r=0.2; fps_batched 32 x 4096 (ragged) K=512; fps_resident 1 x "
          "1,000,000 K=1024; fps_streaming 1 x 4,000,000 K=512; all D=3")

    # ---------------- phase 10: empty dimensions, after every other phase ----------------
    empty_cases = phase10(WRAPPERS, dev)

    # The ring's launches of the three kernels its hops run (phase 6), and
    # rank 0's on the ring across processes (phase 7); every kernel's
    # launches over the examples (phase 8), the sweep's cases that
    # launched it (phase 9) and the directed empty cases' (phase 10).
    for rec in records:
        wrapper = {"knn_topk": "knn_topk_cuda", "chamfer_nn_bidir": "chamfer_nn_cuda",
                   "ball_query": "ball_query_cuda"}.get(rec["name"], rec["name"])
        if rec["name"] in ("knn_topk", "chamfer_nn_bidir", "scatter_add_rows"):
            rec["ring_launches"] = ring_launches[wrapper]
            rec["procs_launches"] = procs_launches[wrapper]
        rec["examples_launches"] = examples_launches[wrapper]
        rec["sweep_cases"] = sweep_cases[wrapper]
        rec["empty_cases"] = empty_cases[wrapper]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all [{gpu_line()}]")
    print(json.dumps({"kernels": records}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
