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
on up to 4,096 queries (indices equal, distances bit-equal).

Beside the plans it times the query sort (``kernels/spatial_sort.py``)
under the plan ``knn_topk_cuda`` picks, each call with its sort included,
held bit-equal to the unsorted call; the kernel alone on the order made
beforehand (``kernel_ms``); the sort alone (``sort_ms``); and, where the
kernel has counting instances (5 <= K <= 64), the counters of one launch
unsorted and sorted (groups, fired votes, drains, insertions, pending
appends; ``fired_share`` = fired / groups). Then, at shapes between the two sides
of the query sort's auto gate (``GATE_SHAPES``: one cloud and many clouds
at 2.5e9-6.4e9 pairs), it times unsorted against queries sorted, sort
included, and names what the gate picks. It prints one JSON line per
shape, a table of the sort columns, the gate table, then the card's name
and power limit. A knn module without launch plans or sorts is timed under
its one launch, unsorted.

Last, the seeding table (``--seeding`` runs it alone): kth-bound seeding
(``knn_topk(sample_bound=True)``) against unseeded at the north star and
16 x 10,000 for K in {16, 32, 64, 100} and at config 4 (1M x 1M) for
K=16, the queries sorted where the gate sorts them: the call with its
sample pass and repair, the bounds alone (``kth_bounds``), the sample's
KNN alone, the seeded and unseeded rounds alone, each sample size in
``SAMPLE_SIZES`` of the shape, and the counters' insertions a query with
and without the seed. Every seeded call is held bit-equal to the unseeded
one.

Then the screen column (``--screen`` runs it alone): the screen and select
of a seeded call of more than one round (``kernels/knn.py`` ``_screener``)
at the north star, K=100, the queries sorted, under every feasible screen
plan (queries a thread, threads, tile; ``screen_plans``), each held
bit-equal to the unseeded call with no query flagged, beside the plan
``knn_topk_cuda`` picks. Exits 1 without a CUDA device.
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
# Sort variants: sort_queries.
SORTS = {"unsorted": False, "queries": True}
CHECK_QUERIES = 4096
BATCH = 20
# (clouds, points a cloud) between 16 x 10,000 (1.6e9 pairs) and the north
# star (1e10), where the query sort's gate (kernels/knn.py sort_gates) is
# set: one large cloud and many mid-size ones on each side of 2^32 pairs.
GATE_SHAPES = ((1, 50_000), (32, 10_000), (1, 70_000), (64, 10_000))
# Seeding table: (label, clouds, points a cloud, Ks, sample sizes; the first
# is the default where P2 >= 4 * 4,096, else the largest power of two with
# P2 >= 4 * s).
SEED_SHAPES = (("north star", 1, 100_000, (16, 32, 64, 100), (6144, 3072, 1536)),
               ("16 x 10,000", 16, 10_000, (16, 32, 64, 100), (2048, 1024, 512)),
               ("config 4", 1, 1_000_000, (16,), (62464, 15616)))


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


def _sort_columns(kk, p1, p2, lengths2, K):
    """The sort variants' times and counters at one shape and K, each held
    bit-equal to the unsorted call."""
    from .kernels import spatial_sort as ss

    base = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sort_queries=False)
    # The kernel alone on the order computed beforehand.
    rows = ss.morton_order(p1).int()
    plan = kk.card_plans(p1, p2, K, 2)[0]
    out = {"sorted_ms": {}, "kernel_ms": {}}
    for name, sq in SORTS.items():
        d, i = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sort_queries=sq)
        if not (torch.equal(d, base[0]) and torch.equal(i, base[1])):
            raise RuntimeError(f"tune_knn: K={K} sorted {name} differs from unsorted")
        out["sorted_ms"][name] = _ms(lambda: kk.knn_topk_cuda(p1, p2, lengths2, K, 2,
                                                              sort_queries=sq))
        r = rows if sq else None
        out["kernel_ms"][name] = _ms(lambda: kk._launch_rounds(p1, p2, lengths2, K, 2,
                                                               plan, r))
    out["sort_ms"] = _ms(lambda: ss.morton_order(p1))
    if kk._counted_instance(p1.shape[2], K, 2):
        out["counters"] = {}
        for name, sq in SORTS.items():
            c = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sort_queries=sq,
                                 instrument=True)[2]
            tot = dict(zip(kk.COUNTERS, c.sum(dim=(0, 1)).tolist()))
            tot["fired_share"] = tot["fired"] / max(tot["groups"], 1)
            out["counters"][name] = tot
    return out


def _gate_table(kk, rng, dev):
    """Lines of unsorted / queries-sorted ms (sort included) at each of
    ``GATE_SHAPES`` and K >= 8, each sorted call held bit-equal to the
    unsorted one, with the gate's pick."""
    lines = []
    for N, P in GATE_SHAPES:
        p1, p2 = (torch.randn((N, P, 3), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(s))
                  for s in rng.integers(0, 2**31, size=2).tolist())
        lengths2 = torch.full((N,), P, dtype=torch.int64, device=dev)
        for K in KS[1:]:
            ms = {}
            for name in ("unsorted", "queries"):
                ms[name] = _ms(lambda: kk.knn_topk_cuda(p1, p2, lengths2, K, 2,
                                                        sort_queries=SORTS[name]))
            base = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sort_queries=False)
            srt = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sort_queries=True)
            if not (torch.equal(base[0], srt[0]) and torch.equal(base[1], srt[1])):
                raise RuntimeError(f"tune_knn: {N} x {P} K={K} sorted queries differ")
            pick = kk.sort_gates(N * P * P, K, True)
            lines.append(f"{N} x {P:,} | {N * P * P:.2e} | {K} | {ms['unsorted']:.3f} | "
                         f"{ms['queries']:.3f} | {ms['queries'] / ms['unsorted']:.3f} | "
                         f"{'queries' if pick else 'unsorted'}")
            print(lines[-1], flush=True)
    return lines


def _seed_row(kk, ss, p1, p2, lengths2, K, sizes):
    """The seeding columns at one shape and K (see the module docstring)."""
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    sq = kk.sort_gates(N * P1 * P2, K, True)
    rows = ss.morton_order(p1) if sq else None
    rows32 = None if rows is None else rows.int()
    plan = kk.card_plans(p1, p2, K, 2)[0]
    base = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sample_bound=False)
    row = {"queries sorted": sq, "unseeded_ms": _ms(
        lambda: kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sample_bound=False)),
        "rounds_alone_ms": {"unseeded": _ms(
            lambda: kk._launch_rounds(p1, p2, lengths2, K, 2, plan, rows32))}}
    kqs = kk._quantiles(K, P2)
    for s in sizes:
        kw = dict(sample_bound=True, sample_s=s)
        out = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, **kw)
        if not (torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])):
            raise RuntimeError(f"tune_knn: seeded K={K} s={s} differs from unseeded")
        taus = kk.kth_bounds(p1, p2, lengths2, kqs, 2, s, rows)
        seeds = [kk.seed_of(t) for t in taus]
        m_max = kk.bound_ranks(lengths2, kqs, s, P2)[0]
        sidx = (torch.arange(s, device=p2.device) * P2 // s)[None].expand(N, s)
        sample = kk._gather_rows(p2, sidx).contiguous()
        len_s = torch.clamp_max(lengths2, s)
        m = min(-(-m_max // 8) * 8, s)
        splan = kk.card_plans(p1, sample, m, 2)[0]
        row[f"s={s}"] = {
            "seeded_ms": _ms(lambda: kk.knn_topk_cuda(p1, p2, lengths2, K, 2, **kw)),
            "bounds_ms": _ms(lambda: kk.kth_bounds(p1, p2, lengths2, kqs, 2, s, rows)),
            "sample_knn_ms": _ms(lambda: kk._launch_rounds(p1, sample, len_s, m, 2, splan,
                                                           rows32)),
            "sample_K": m, "sample_plan": kk.plan_name(splan),
            "seeded_rounds_alone_ms": _ms(lambda: kk._launch_rounds(
                p1, p2, lengths2, K, 2, plan, rows32, seeds=seeds)),
            "repair": int(kk.repair_gate(kk._launch_rounds(
                p1, p2, lengths2, K, 2, plan, rows32, seeds=seeds)[1].split(
                    kk.ROUND_K, dim=2), lengths2, K)),
        }
    if kk._counted_instance(D, K, 2):
        tau = kk.kth_bounds(p1, p2, lengths2, [K], 2, sizes[0])[0]
        row["insertions_a_query"] = {
            name: kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sort_queries=sq,
                                   instrument=True, **kw)[2][..., 3].sum().item() / (N * P1)
            for name, kw in (("unseeded", {}), ("seeded", {"ub": tau}))}
    return row


def _seed_table(kk, rng, dev):
    """Lines of the seeding table, one JSON object per shape and K."""
    from .kernels import spatial_sort as ss

    lines = []
    for label, N, P, Ks, sizes in SEED_SHAPES:
        p1, p2 = (torch.randn((N, P, 3), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(s))
                  for s in rng.integers(0, 2**31, size=2).tolist())
        lengths2 = torch.full((N,), P, dtype=torch.int64, device=dev)
        for K in Ks:
            row = {"shape": label, "K": K, **_seed_row(kk, ss, p1, p2, lengths2, K, sizes)}
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    return lines


def _screen_column(kk, rng, dev, K=100):
    """The screen column's line: every screen plan's time at the north
    star (screen and select, one call a chunk, CUDA events)."""
    from .kernels import spatial_sort as ss

    p1, p2 = (torch.randn((1, 100_000, 3), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(s))
              for s in rng.integers(0, 2**31, size=2).tolist())
    lengths2 = torch.full((1,), 100_000, dtype=torch.int64, device=dev)
    P2 = p2.shape[1]
    s = kk._default_sample_s(P2)
    rows = ss.morton_order(p1)
    seed = kk.seed_of(kk.kth_bounds(p1, p2, lengths2, [K], 2, s, rows)[0])
    cap = kk.screen_cap(K, P2, s)
    base = kk.knn_topk_cuda(p1, p2, lengths2, K, 2, sample_bound=False)
    base = (kk._gather_rows(base[0], rows), kk._gather_rows(base[1], rows))
    shape = (kk._rounds(K, P2), 1, p1.shape[1], kk.ROUND_K)
    out = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int64,
                                                      device=dev))
    chosen, plans = kk.screen_plans(p1, p2, 2, kk._screen_chunk(1, p1.shape[1], cap))
    times = {}
    for plan in plans:
        screen = kk._screener(p1, p2, lengths2, 2, rows.int(), plan=plan)
        flags = screen(K, seed, cap, out)
        d, i = kk._join(list(out[0]), list(out[1]), K)
        if flags.any() or not (torch.equal(d, base[0]) and torch.equal(i, base[1])):
            raise RuntimeError(f"tune_knn: screen plan {kk.plan_name(plan)} disagrees "
                               "with the unseeded call")
        times[kk.plan_name(plan)] = _ms(lambda: screen(K, seed, cap, out))
    return json.dumps({"shape": "north star", "K": K, "screen plan": kk.plan_name(chosen),
                       "ms": times[kk.plan_name(chosen)], "cap": cap, "plans": times})


def _table_line(label, K, r):
    ms = " / ".join(f"{r['sorted_ms'][n]:.3f} ({r['kernel_ms'][n]:.3f})" for n in SORTS)
    share = " / ".join(f"{r['counters'][n]['fired_share']:.4f}"
                       for n in SORTS) if "counters" in r else "-"
    return f"{label} | {K} | {ms} | {r['sort_ms']:.3f} | {share}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--seeding", action="store_true",
                    help="run the seeding table alone")
    ap.add_argument("--screen", action="store_true",
                    help="run the screen column alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_knn: no CUDA device", file=sys.stderr)
        return 1
    from .kernels import knn as kk
    from .ops.knn import _apply_pad_conventions

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    card_plans = getattr(kk, "card_plans", None)
    has_sorts = hasattr(kk, "sort_gates")
    lines, table = [], []
    only = args.seeding or args.screen
    for label, p1, p2, lengths2 in ([] if only else _shapes(rng, dev)):
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
                if has_sorts:
                    kw.update(sort_queries=False)
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
            if has_sorts:
                row["K"][K].update(_sort_columns(kk, p1, p2, lengths2, K))
                table.append(_table_line(label, K, row["K"][K]))
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if table:
        print("shape | K | unsorted / queries sorted ms, sort included (kernel "
              "alone) | query sort alone ms | fired share unsorted / queries")
        print("\n".join(table))
        head = ("gate shape | pairs | K | unsorted ms | queries sorted ms (sort "
                "included) | ratio | the gate's pick")
        print(head)
        table += [head, *_gate_table(kk, rng, dev)]
    if hasattr(kk, "kth_bounds") and not args.screen:
        print("seeding table: ms, queries sorted where the gate sorts them")
        table += ["seeding table", *_seed_table(kk, rng, dev)]
    if hasattr(kk, "screen_plans") and not args.seeding:
        table += ["screen column", _screen_column(kk, rng, dev)]
        print(table[-1], flush=True)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(gpu)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines + table) + "\n" + gpu + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
