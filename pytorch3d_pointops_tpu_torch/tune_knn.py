"""Times the KNN top-K kernel (``csrc/knn.cu``) under every launch plan it
can take, on one CUDA card, to check the plan that ``knn_topk_cuda`` picks.

Run from the repository root on a machine with a CUDA card:

    python -m pytorch3d_pointops_tpu_torch.tune_knn [--seed 0] [--out FILE]

Shapes (D=3, norm 2, Gaussian points): the north star, 1 x 100,000 queries
against 100,000 points; config 1, 2 clouds of 1,000/800 points against the
same shifted by 0.05; and 16 x 10,000 against 16 x 10,000. For each shape
and K in {1, 8, 16, 32, 64, 100} it times ``knn_topk_cuda`` under the plan
it picks and under every other feasible plan (CUDA events, median of 5
after a warm-up; calls under 1 ms timed 20 at a time), and holds each
plan's output against ``knn_topk_plain``
on up to 4,096 queries (indices equal, distances bit-equal). It prints one
JSON line per shape, then the card's name and power limit. A knn module
without launch plans is timed under its one launch. Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

KS = (1, 8, 16, 32, 64, 100)
CHECK_QUERIES = 4096
BATCH = 20


def _ms(fn, reps=5):
    """Median over ``reps`` of the CUDA-event time of one call. A call that
    took under 1 ms in the warm-up is timed BATCH at a time (the time of the
    batch over BATCH): such a call is mostly the host's launch work, which
    varies from call to call."""
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


def _shapes(rng, dev):
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def gauss(*shape):
        return rng.normal(size=shape).astype(np.float32)

    ns1, ns2 = gauss(1, 100_000, 3), gauss(1, 100_000, 3)
    yield "north star", t(ns1), t(ns2), t(np.array([100_000]), torch.int64)
    c1 = np.zeros((2, 1000, 3), np.float32)
    c1[0], c1[1, :800] = gauss(1000, 3), gauss(800, 3)
    yield ("config 1", t(c1), t(c1 + np.float32(0.05)),
           t(np.array([1000, 800]), torch.int64))
    yield ("16 x 10,000", t(gauss(16, 10_000, 3)), t(gauss(16, 10_000, 3)),
           t(np.full(16, 10_000), torch.int64))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_knn: no CUDA device", file=sys.stderr)
        return 1
    from .kernels import knn as kk
    from .ops.knn import _apply_pad_conventions

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    card_plans = getattr(kk, "card_plans", None)
    lines = []
    for label, p1, p2, lengths2 in _shapes(rng, dev):
        N, P1, _ = p1.shape
        sub = min(P1, -(-CHECK_QUERIES // N))
        row = {"shape": label, "N": N, "P1": P1, "P2": p2.shape[1], "D": 3, "K": {}}
        for K in KS:
            ref = kk.knn_topk_plain(p1[:, :sub].contiguous(), p2, lengths2, K, 2)
            ref = _apply_pad_conventions(*ref, lengths2.new_full((N,), sub),
                                         lengths2, K, sub)
            chosen, plans = card_plans(p1, p2, K, 2) if card_plans else (None, [None])
            times = {}
            for plan in plans:
                kw = {} if plan is None else {"_plan": plan}
                d, i = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, **kw)
                d, i = _apply_pad_conventions(d[:, :sub], i[:, :sub],
                                              lengths2.new_full((N,), sub),
                                              lengths2, K, sub)
                name = "default" if plan is None else kk.plan_name(plan)
                if not (torch.equal(i, ref[1]) and torch.equal(d, ref[0])):
                    raise RuntimeError(f"tune_knn: {label} K={K} {name} disagrees "
                                       "with knn_topk_plain")
                times[name] = _ms(lambda: kk.knn_topk_cuda(p1, p2, lengths2, K, 2, **kw))
            pick = "default" if chosen is None else kk.plan_name(chosen)
            row["K"][K] = {"plan": pick, "ms": times[pick], "plans": times}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
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
