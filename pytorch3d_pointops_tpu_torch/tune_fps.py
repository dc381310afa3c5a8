"""Times the three FPS kernels against one another on one CUDA card, to set
the routing thresholds of ``ops/fps.py``.

Run from the repository root on a machine with a CUDA card:

    python -m pytorch3d_pointops_tpu_torch.tune_fps [--seed 0] [--out FILE]

For each batch shape (N clouds of P points, D=3, uniform in the unit cube,
at K rounds) it times every entry point that takes the shape (CUDA events,
median of 3 after a warm-up) and prints one JSON line per shape with the
grid kernel's launch plan, then the card's name and power limit. Each timed
output is also checked against ``fps_plain``'s at one shape per kernel.
Where the plan keeps a slice's coordinates in registers, the same call is
also timed under a plan of 1024 threads that keeps them in shared memory
(``smem_coords_ms``). On the block route the line names the block kernel's
plan (``block_plan``) and times every block plan that holds the cloud
(``block_plans_ms``, ``fps_batched`` forced to each). A copy of this file
in an older tree's package times that tree's kernels (without plans).
``--block-only`` times only the shapes of the block route.

``--cluster`` prints the table behind ``ops/fps.py`` ``route``'s choice
between the cluster path and the grid kernel instead: for N in {1, 4, 8}
clouds of P in {16k, 20k, 80k, 160k, 250k} points, and single clouds of
180k and 200k and two of 250k (K = 1024), the ms of a
call and the us of a round (one selection in every cloud: K - 1 a call)
of ``fps_clustered`` under its plan and under each cluster size forced
(``cluster_us``), and of ``fps_resident``, each output held equal to
``fps_plain``'s.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

SHAPES = (
    # (N, P, K): a few clouds around one block's capacity, then large clouds.
    (1, 2048, 512), (1, 4096, 512), (1, 8192, 512), (1, 14000, 512),
    (2, 8192, 512), (4, 8192, 512), (8, 8192, 512), (4, 14000, 512),
    (8, 14000, 512), (16, 14000, 512), (32, 4096, 512), (1, 100_000, 512),
    (1, 500_000, 512), (1, 1_000_000, 1024), (1, 1_800_000, 1024),
    (1, 2_000_000, 512), (1, 3_000_000, 512), (1, 4_000_000, 512),
    (1, 6_000_000, 512),
)


def _ms(fn, reps=3):
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


CLUSTER_SHAPES = tuple((N, P) for P in (16_000, 20_000, 80_000, 160_000, 250_000)
                       for N in (1, 4, 8)) + ((1, 180_000), (1, 200_000), (2, 250_000))


def cluster_table(gen, dev, K=1024):
    """The cluster path against the grid kernel (``--cluster``): one JSON
    line a shape."""
    from .kernels import fps as kf

    lines = []
    active = kf._cluster_card(dev.index)
    for N, P in CLUSTER_SHAPES:
        pts = torch.rand((N, P, 3), generator=gen, device=dev)
        lengths = torch.full((N,), P, dtype=torch.int64, device=dev)
        Ks = torch.full((N,), K, dtype=torch.int64, device=dev)
        starts = torch.zeros((N,), dtype=torch.int64, device=dev)
        args = (pts, lengths, Ks, starts, K)
        ref = kf.fps_plain(*args)
        plan = kf.card_cluster_plan(pts)
        row = {"N": N, "P": P, "K": K, "plan": kf.cluster_plan_name(plan)}
        runs = {"grid": (kf.fps_resident, None)}
        for c in kf.CLUSTERS:
            sl = -(-P // c)
            fit = next(((t, s) for t, s in kf.CLUSTER_BLOCKS if t * s >= sl), None)
            if fit and active[(*fit, c)] > 0:
                runs[f"c{c}"] = (kf.fps_clustered, plan._replace(
                    cluster=c, threads=fit[0], slots=fit[1], slice=sl,
                    waves=-(-N // active[(*fit, c)])))
        times = {}
        for name, (fn, forced) in runs.items():
            if not torch.equal(fn(*args, _plan=forced), ref):
                raise RuntimeError(f"tune_fps: {name} at {N} x {P} disagrees with fps_plain")
            times[name] = _ms(lambda: fn(*args, _plan=forced))
        row["cluster_ms"] = times[f"c{plan.cluster}"]
        row["grid_ms"] = times["grid"]
        row["cluster_us_round"] = round(times[f"c{plan.cluster}"] * 1e3 / (K - 1), 4)
        row["grid_us_round"] = round(times["grid"] * 1e3 / (K - 1), 4)
        row["cluster_us"] = {k: round(v * 1e3 / (K - 1), 4) for k, v in times.items()
                             if k != "grid"}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--block-only", action="store_true",
                    help="only the shapes fps_batched takes")
    ap.add_argument("--cluster", action="store_true",
                    help="only the cluster path against the grid kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_fps: no CUDA device", file=sys.stderr)
        return 1
    from .kernels import fps as kf

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    block_max, resident_max = kf.fps_limits(3, dev)
    lines = []
    checked = set()
    plans = hasattr(kf, "card_plan")
    for N, P, K in () if args.cluster else SHAPES:
        if args.block_only and P > block_max:
            continue
        pts = torch.rand((N, P, 3), generator=gen, device=dev)
        lengths = torch.full((N,), P, dtype=torch.int64, device=dev)
        Ks = torch.full((N,), K, dtype=torch.int64, device=dev)
        starts = torch.zeros((N,), dtype=torch.int64, device=dev)
        row = {"N": N, "P": P, "D": 3, "K": K}
        for name, fn, cap in (("batched", kf.fps_batched, block_max),
                              ("resident", kf.fps_resident, resident_max),
                              ("streaming", kf.fps_streaming, None)):
            if cap is not None and P > cap:
                row[name + "_ms"] = None
                continue
            if name not in checked and P <= 100_000:
                out = fn(pts, lengths, Ks, starts, K)
                ref = kf.fps_plain(pts, lengths, Ks, starts, K)
                if not torch.equal(out, ref):
                    raise RuntimeError(f"tune_fps: {name} disagrees with fps_plain")
                checked.add(name)
            row[name + "_ms"] = _ms(lambda: fn(pts, lengths, Ks, starts, K))
        if hasattr(kf, "_block_plan") and P <= block_max:
            row["block_plan"] = kf.block_plan_name(kf._block_plan(P, 3))
            row["block_plans_ms"] = {
                f"t{t}/s{sl}": _ms(lambda: kf.fps_batched(
                    pts, lengths, Ks, starts, K,
                    _plan=kf._block_plan(P, 3)._replace(threads=t, slots=sl)))
                for t, sl in kf.BLOCK_PLANS[3] if t * sl >= P}
        if plans and P > block_max:
            plan = kf.card_plan(pts)
            row["plan"] = kf.plan_name(plan)
            if (plan.threads, plan.slots) in kf.REG_PLANS:
                S = -(-plan.slice // kf.GRID_THREADS)
                alt = plan._replace(threads=kf.GRID_THREADS, slots=16, smem_slots=S,
                                    smem_bytes=4 * 3 * (S * kf.GRID_THREADS + 1))
                row["smem_coords_ms"] = _ms(lambda: kf.fps_streaming(
                    pts, lengths, Ks, starts, K, _plan=alt))
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.cluster:
        lines = cluster_table(gen, dev)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"limits_D3": {"block": block_max, "resident": resident_max},
                      "gpu": gpu}))
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n" + gpu + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
