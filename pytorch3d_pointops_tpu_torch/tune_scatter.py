"""Times the deterministic scatter (``csrc/scatter.cu``) under the plan that
``scatter_plan`` picks and under the other plans it could take, on one CUDA
card, to check the routing: the bucket size (``shift``) and where the
bucket kernel alone (no partition) is faster than the partition.

Run from the repository root on a machine with a CUDA card:

    python -m pytorch3d_pointops_tpu_torch.tune_scatter [--seed 0] [--out FILE]
        [--direct-only]

Shapes (``SHAPES``): the main paths' scatters (the north-star KNN backward,
1.6M entries into 100,000 rows; config 3's chamfer K=1 backward, 16 x
10,000; config 2's three backward scatters; config 1's KNN backward;
config 4's 16M entries into 1M rows), a skewed input (100,000 of 200,000
entries on one row), every entry on one row, and 8 and 33 channels. For
each it holds the picked plan bit-equal to ``scatter_add_plain`` on CPU
copies and from run to run, and every other plan bit-equal to it; times
each plan (CUDA events, median of 5 after a warm-up; calls under 1 ms
timed 20 at a time) and step by step (``launch_steps``: CUDA events
recorded between its launches), ``scatter_add_plain`` on the card,
and ``index_add_`` into the same rows, non-deterministic and under
``torch.use_deterministic_algorithms(True)`` (``library_ms``). Then the
direct table (alone with ``--direct-only``): the bucket kernel alone
against the partition at N * P2 from 800 to 2,048 rows for 2,048-65,536
entries, and the plan ``scatter_plan`` picks. It prints one JSON line per shape,
the direct table, then the card's name and power limit. A scatter module
without plans (an older tree) is timed under its one chain. Exits 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

BATCH = 20
# (label, N, E, P2, C, targets): "uniform" over [-1, P2) (about 1 / (P2 + 1)
# skipped), "sorted" the same in ascending order (each bucket's entries
# contiguous, so the bucket sum reads contrib in order: what carrying
# contrib through the partition would give it), "skew" with every second
# entry on row 7, "one row" all on row 7.
SHAPES = (
    ("north star rows", 1, 1_600_000, 100_000, 3, "uniform"),
    ("north star rows, sorted", 1, 1_600_000, 100_000, 3, "sorted"),
    ("config 3 k1", 16, 10_000, 10_000, 3, "uniform"),
    ("config 2 fps gather", 32, 512, 4_096, 3, "uniform"),
    ("config 2 ball gather", 32, 16_384, 4_096, 3, "uniform"),
    ("config 1 rows", 2, 8_000, 800, 3, "uniform"),
    ("config 4 rows", 1, 16_000_000, 1_000_000, 3, "uniform"),
    ("config 4 rows, sorted", 1, 16_000_000, 1_000_000, 3, "sorted"),
    ("skewed", 1, 200_000, 100_000, 3, "skew"),
    ("one row", 1, 200_000, 100_000, 3, "one row"),
    ("C=8", 1, 200_000, 10_000, 8, "uniform"),
    ("C=33", 1, 200_000, 10_000, 33, "uniform"),
)
DIRECT_ROWS = (800, 1_024, 1_600, 1_800, 2_048)
DIRECT_ENTRIES = (2_048, 4_096, 6_144, 8_192, 12_288, 16_384, 65_536)


def _ms(fn, reps=5):
    """Median over ``reps`` of the CUDA-event time of one call. A call that
    took under 1 ms in the warm-up is timed BATCH at a time (the time of the
    batch over BATCH): such a call is mostly the host's launch work."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    batch = BATCH if start.elapsed_time(end) < 1.0 else 1
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def launch_steps(idx, contrib, P2, plan=None, reps=10):
    """Median CUDA-event time in ms of each step of one scatter call on CUDA
    tensors (``kernels.scatter.step_names``: the zeroing, the histogram,
    each partition pass, the bucket sum; or the bucket sum alone)."""
    from .kernels import scatter as ks

    N, E, C = contrib.shape
    if hasattr(ks, "scatter_plan"):
        plan = plan or ks.scatter_plan(N, E, P2, C)
        names, kw = ks.step_names(plan), {"plan": plan}
    else:  # an older tree: a radix sort over every key bit, a segment sum
        passes = ks.radix_digits(N, E, P2)[0]
        names = ("zero", "histogram", *(f"pass {p + 1}" for p in range(passes)),
                 "segment sum")
        kw = {}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    for e in events:
        e.record()
    torch.cuda.synchronize()
    times = [[] for _ in names]
    for _ in range(reps):
        ks._launch(idx, contrib, P2, events=events, **kw)
        torch.cuda.synchronize()
        for i, t in enumerate(times):
            t.append(events[i].elapsed_time(events[i + 1]))
    return {n: statistics.median(t) for n, t in zip(names, times)}


# CUgraphNodeType (cuda.h) of the nodes a captured call can hold.
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 6: "event wait",
               7: "event record", 10: "mem alloc", 11: "mem free"}


def device_ops(fn) -> list[str]:
    """The kinds ("kernel", "memset", ...) of the device operations that one
    call of ``fn`` enqueues: the call, after a warm-up call, captured into
    a CUDA graph whose nodes the driver lists. (``torch.profiler`` serves
    less well: late in a long process it can record none of a call's
    device activities.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(_NODE_KINDS.get(kind.value, f"node type {kind.value}"))
    return kinds


def library_ms(idx, contrib, P2, deterministic: bool, reps=10, timer=None):
    """The time of one ``index_add_`` of the same entries into a flat
    (N * P2 + 1, C) buffer whose last row takes the skipped ones, as
    ``scatter_add_plain`` adds them; with ``deterministic``, under
    ``torch.use_deterministic_algorithms(True)``, the global flags restored
    after. ``timer(fn)`` gives the time in ms (default: ``_ms`` over
    ``reps``), so that a caller can time it as it times the kernel."""
    N, E, C = contrib.shape
    rows = torch.where(
        idx >= 0, idx + torch.arange(N, device=idx.device)[:, None] * P2, N * P2
    ).reshape(-1)
    flat = contrib.reshape(-1, C)
    out = torch.zeros((N * P2 + 1, C), device=contrib.device)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(deterministic)
    try:
        fn = lambda: out.index_add_(0, rows, flat)  # noqa: E731
        return timer(fn) if timer else _ms(fn, reps=reps)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def targets(rng, N, E, P2, kind):
    """idx (N, E) int64 on the host for a shape's targets (``SHAPES``)."""
    if kind == "one row":
        return np.full((N, E), 7, dtype=np.int64)
    idx = rng.integers(-1, P2, size=(N, E))
    if kind == "skew":
        idx[:, ::2] = 7
    elif kind == "sorted":
        idx.sort(axis=1)
    return idx


def plan_name(plan) -> str:
    if plan is None:
        return "default"
    if plan.passes == 0:
        return "direct"
    return f"rows 2^{plan.shift}, {plan.passes} pass{'es' if plan.passes > 1 else ''}"


def _plans(ks, N, E, P2, C):
    """The plan ``scatter_plan`` picks, then every other plan with buckets
    of 2^(shift - 3) up to 2^11 rows and at most two partition passes, and
    no partition where every row fits one bucket."""
    pick = ks.scatter_plan(N, E, P2, C)
    rows = N * P2
    bits = max(1, rows.bit_length())
    plans = [pick]
    if pick.passes and rows <= 1 << ks._MAX_BUCKET_BITS:
        plans.append(ks.Plan(bits, 0, 0, pick.channels))
    low = max(0, (pick.shift if pick.passes else bits) - 3)
    for shift in range(low, ks._MAX_BUCKET_BITS + 1):
        digit_bits = bits - shift
        passes = -(-digit_bits // ks._MAX_DIGIT_BITS)
        if digit_bits <= 0 or passes > 2:
            continue
        plan = ks.Plan(shift, passes, -(-digit_bits // passes), pick.channels)
        if plan != pick:
            plans.append(plan)
    return pick, plans


def tune_shape(ks, dev, rng, label, N, E, P2, C, kind):
    idx_h = targets(rng, N, E, P2, kind)
    c_h = rng.normal(size=(N, E, C)).astype(np.float32)
    idx = torch.from_numpy(idx_h).to(dev)
    contrib = torch.from_numpy(c_h).to(dev)
    ref = ks.scatter_add_plain(torch.from_numpy(idx_h), torch.from_numpy(c_h), P2)
    out = ks.scatter_add_rows(idx, contrib, P2)
    if not (torch.equal(out.cpu(), ref)
            and torch.equal(out, ks.scatter_add_rows(idx, contrib, P2))):
        raise RuntimeError(f"tune_scatter: {label} not bit-equal to scatter_add_plain "
                           "or run to run")
    row = {"shape": label, "N": N, "E": E, "P2": P2, "C": C, "targets": kind}
    if hasattr(ks, "scatter_plan"):
        pick, plans = _plans(ks, N, E, P2, C)
        times, steps = {}, {}
        for plan in plans:
            if not torch.equal(ks._launch(idx, contrib, P2, plan=plan), out):
                raise RuntimeError(f"tune_scatter: {label} {plan_name(plan)} differs")
            times[plan_name(plan)] = _ms(lambda: ks._launch(idx, contrib, P2, plan=plan))
            steps[plan_name(plan)] = {k: round(v, 4) for k, v in
                                      launch_steps(idx, contrib, P2, plan, reps=5).items()}
        row.update(plan=plan_name(pick), ms=times[plan_name(pick)], plans=times,
                   plan_steps=steps)
    else:
        row.update(plan="default", ms=_ms(lambda: ks.scatter_add_rows(idx, contrib, P2)))
    row["steps"] = launch_steps(idx, contrib, P2)
    row["plain_ms"] = _ms(lambda: ks.scatter_add_plain(idx, contrib, P2))
    row["library_ms"] = library_ms(idx, contrib, P2, False)
    row["library_det_ms"] = library_ms(idx, contrib, P2, True)
    return row


def direct_table(ks, dev, rng):
    """The bucket kernel alone against the partition that ``scatter_plan``
    takes past one block (one pass, buckets of 2^(bits - 8) rows) at N * P2
    up to 2,048 rows (one cloud), C=3, uniform targets."""
    lines = []
    for P2 in DIRECT_ROWS:
        bits = P2.bit_length()
        shift = max(0, bits - ks._PLAN_DIGIT_BITS)
        for E in DIRECT_ENTRIES:
            idx = torch.from_numpy(targets(rng, 1, E, P2, "uniform")).to(dev)
            contrib = torch.randn((1, E, 3), device=dev)
            direct = ks.Plan(bits, 0, 0, 3)
            part = ks.Plan(shift, 1, bits - shift, 3)
            if not torch.equal(ks._launch(idx, contrib, P2, plan=direct),
                               ks._launch(idx, contrib, P2, plan=part)):
                raise RuntimeError(f"tune_scatter: direct differs at {E} into {P2}")
            ms = {plan_name(p): _ms(lambda: ks._launch(idx, contrib, P2, plan=p))
                  for p in (direct, part)}
            lines.append(f"{P2} rows | {E} entries | direct {ms['direct']:.4f} ms | "
                         f"partition {ms[plan_name(part)]:.4f} ms | picked "
                         f"{plan_name(ks.scatter_plan(1, E, P2, 3))}")
            print(lines[-1], flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--direct-only", action="store_true",
                    help="only the direct table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_scatter: no CUDA device", file=sys.stderr)
        return 1
    from .kernels import scatter as ks

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    lines = []
    for shape in () if args.direct_only else SHAPES:
        lines.append(json.dumps(tune_shape(ks, dev, rng, *shape)))
        print(lines[-1], flush=True)
    if hasattr(ks, "scatter_plan"):
        print("direct table: rows | entries | bucket kernel alone | partition")
        lines += direct_table(ks, dev, rng)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(gpu)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n" + gpu + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
