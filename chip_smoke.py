#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (pytorch3d_pointops_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0]

Phase 1 builds the CUDA kernels from ``pytorch3d_pointops_tpu_torch/csrc``
(five sources, one ``nvcc`` each, in parallel) into ``build/`` and prints
the card's name and power limit. Phase 2 holds every kernel against its
plain PyTorch twin on the card: ragged lengths, fully masked clouds, norms
1 and 2, D in {3, 16}, K in {1, 8, 16, 64, 100} (KNN) and {1, 32, 100, 500}
(ball query), points on a 1/8 grid so that ties and ball boundaries are
real, every FPS entry point with per-cloud K (K past the length and past the
number of distinct points), explicit starts and an empty cloud, and the
scatter: its radix sort (``sort_plan``) equal to the stable argsort
(``segment_plan``) at one, two and three passes, on uniform targets and on
targets that crowd 16 rows, and both entry points run twice and compared
bit for bit with each other and with the plain twin on CPU copies. Phase 3
drives two main paths at
full size through the public entry points, each with every launch counter
set to 0 just before and read just after:

* config 3: ``chamfer_distance`` on two ``Pointclouds`` of 16 x 10,000
  points (ragged 9,000-10,000) with normals and colors, mean/mean, five SGD
  steps of forward and backward; config 1: ``knn_points`` on 2 clouds of
  1000/800 points, K=8; north star: ``knn_points`` on 100k x 100k points,
  K=16; both forward and backward;
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
against its plain twin at that shape (indices equal, values within 1e-5)
and the scatters run twice for bit-equality; each scatter's sort and
segment sum are timed apart, launch by launch, as is a skewed scatter (one
row of 100,000 entries), and config 2's backward scatters print their
longest segment. The line before the last is
one JSON object with a record per kernel; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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


def scatter_steps(idx, contrib, P2, reps=10):
    """Median CUDA-event time in ms of each step of one scatter call: the
    zeroing of its counters, the histogram, each radix pass, the segment
    sum."""
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    passes = ks.radix_digits(idx.shape[0], idx.shape[1], P2)[0]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(passes + 4)]
    for e in events:
        e.record()
    torch.cuda.synchronize()
    times = [[] for _ in range(passes + 3)]
    for _ in range(reps):
        ks._launch(idx, contrib, P2, events=events)
        torch.cuda.synchronize()
        for i, t in enumerate(times):
            t.append(events[i].elapsed_time(events[i + 1]))
    names = ["zero", "histogram", *(f"pass {p + 1}" for p in range(passes)),
             "segment sum"]
    return {n: statistics.median(t) for n, t in zip(names, times)}


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_points(rng, shape):
    """Coordinates on a 1/8 grid over [-0.5, 0.5]: many exact duplicates."""
    return rng.integers(-4, 5, size=shape).astype(np.float32) / 8.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import pytorch3d_pointops_tpu_torch as ppt
    from pytorch3d_pointops_tpu_torch import _build
    from pytorch3d_pointops_tpu_torch.kernels import ball_query as kb
    from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
    from pytorch3d_pointops_tpu_torch.kernels import fps as kf
    from pytorch3d_pointops_tpu_torch.kernels import knn as kk
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks
    from pytorch3d_pointops_tpu_torch.ops.knn import _apply_pad_conventions

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
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {gpu_line()}")

    stats = {k: {"err": 0.0} for k in ("knn", "chamfer", "rows", "k1", "ball",
                                       "fps_batched", "fps_resident",
                                       "fps_streaming")}

    def note_err(key, err):
        stats[key]["err"] = max(stats[key]["err"], float(err))

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
                err = (dk - dp).abs().max().item()
                note_err("knn", err)
                require(err <= TOL, f"knn D={D} norm={norm} K={K}: err {err}")
                require(torch.equal(ik, ip), f"knn D={D} norm={norm} K={K}: idx")
            # Two sides of 2,500 points span several blocks in each direction.
            for x, y, l1, l2 in (
                (p1, p2, lengths1, lengths2),
                (T(grid_points(rng, (2, 2500, D))), T(grid_points(rng, (2, 2600, D))),
                 T(np.array([2500, 1777]), torch.int64),
                 T(np.array([2300, 2600]), torch.int64)),
            ):
                outk = kc.chamfer_nn_cuda(x, y, l1, l2, norm)
                outp = kc.chamfer_nn_plain(x, y, l1, l2, norm)
                torch.cuda.synchronize()
                for a, b in ((outk[0], outp[0]), (outk[2], outp[2])):
                    require(torch.equal(torch.isinf(a), torch.isinf(b)),
                            f"chamfer_nn D={D} norm={norm}: inf pattern")
                    fin = torch.isfinite(a)
                    err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
                    note_err("chamfer", err)
                    require(err <= TOL, f"chamfer_nn D={D} norm={norm}: err {err}")
                require(torch.equal(outk[1], outp[1]) and torch.equal(outk[3], outp[3]),
                        f"chamfer_nn D={D} norm={norm}: idx")
    # The scatter: its radix sort against the stable argsort at one, two and
    # three passes (N * P2 of 2,000, 100,000 and 5,000,000 buckets), on
    # uniform targets and on targets where half the entries share 16 rows;
    # both entry points bit-equal run to run and to the plain twin on CPU
    # copies (which sums each row in entry order, as the kernel does), and
    # within TOL of the plain twin on the card (float atomics) where no row
    # is long.
    def hub_targets(N, E, P2):
        hubs = rng.integers(0, P2, size=16)
        return np.where(rng.uniform(size=(N, E)) < 0.5, rng.choice(hubs, size=(N, E)),
                        rng.integers(-1, P2, size=(N, E)))

    for N, E, P2, C in ((3, 4097, 1000, 3), (1, 777, 64, 6), (2, 999, 300, 11),
                        (2, 3000, 1000, 3), (4, 50000, 25000, 3),
                        (5, 200000, 1_000_000, 3)):
        for hub in (False, True):
            idx = T(hub_targets(N, E, P2) if hub else rng.integers(-1, P2, size=(N, E)),
                    torch.int64)
            contrib = T(rng.normal(size=(N, E, C)).astype(np.float32))
            what = f"{N}x{E} P2={P2} C={C} hub={hub}"
            plan, ref_plan = ks.sort_plan(idx, P2), ks.segment_plan(idx, P2)
            require(torch.equal(plan[0], ref_plan[0]) and torch.equal(plan[1], ref_plan[1]),
                    f"sort_plan {what} ({ks.radix_digits(N, E, P2)[0]} passes)")
            cpu_ref = ks.scatter_add_plain(idx.cpu(), contrib.cpu(), P2)
            for key, wrapper in (("rows", ks.scatter_add_rows), ("k1", ks.scatter_add_k1)):
                out1 = wrapper(idx, contrib, P2)
                out2 = wrapper(idx, contrib, P2)
                torch.cuda.synchronize()
                require(torch.equal(out1, out2), f"scatter {key} {what}: not bit-equal")
                require(torch.equal(out1.cpu(), cpu_ref),
                        f"scatter {key} {what}: not bit-equal to the CPU twin")
                if not hub:
                    err = (out1 - ks.scatter_add_plain(idx, contrib, P2)).abs().max().item()
                    note_err(key, err)
                    require(err <= TOL, f"scatter {key} {what}: err {err}")

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

    counters = (kk.knn_topk_cuda, kc.chamfer_nn_cuda, ks.scatter_add_rows,
                ks.scatter_add_k1)
    for c in counters:
        c.launches = 0
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
    launches = {c.__name__: c.launches for c in counters}
    # -- end of the main path --
    print(f"phase 3: main-path launches {json.dumps(launches)}")
    require(all(v > 0 for v in launches.values()), "a kernel of the path never ran")
    print(f"  config 3 chamfer losses {losses}; step ms "
          f"{[round(t, 3) for t in step_ms]}, median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], "loss did not fall")
    print(f"  config 1 knn K=8 fwd+bwd median {c1_ms:.3f} ms")
    print(f"  north-star knn 100k x 100k K=16 fwd+bwd median {ns_ms:.3f} ms")

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

    counters2 = (kf.fps_batched, kf.fps_resident, kf.fps_streaming,
                 kb.ball_query_cuda, ks.scatter_add_rows)
    for c in (*counters, *counters2):
        c.launches = 0
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
    launches2 = {c.__name__: c.launches for c in counters2}
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
    # Config 2's backward scatters, recorded in one more step: each one's
    # longest segment (the entries of its busiest target row, one thread's
    # serial sum), its skipped entries and its time. Beside them, the ball
    # gather's index as it was before its padded slots were skipped: every
    # padded slot sent to row 0 of its cloud.
    def longest_segment(idx, P2):
        rows = (idx + torch.arange(idx.shape[0], device=dev)[:, None] * P2)[idx >= 0]
        return int(torch.bincount(rows).max()) if rows.numel() else 0

    calls = []
    launch = ks._launch

    def recording(idx, contrib, P2, events=None):
        calls.append((idx, contrib, P2))
        return launch(idx, contrib, P2, events)

    ks._launch = recording
    try:
        group_step(pts2)
    finally:
        ks._launch = launch
    require(len(calls) == 3, f"config 2 backward made {len(calls)} scatters, not 3")
    scatter_rows = ks.scatter_add_rows
    for i, (idx, contrib, P2) in enumerate(calls):
        print(f"  config 2 backward scatter {i}: {idx.shape[0]} x {idx.shape[1]} "
              f"entries ({int((idx < 0).sum())} skipped) into {P2} rows, longest "
              f"segment {longest_segment(idx, P2)}, "
              f"{cuda_ms(lambda: scatter_rows(idx, contrib, P2), reps=10):.4f} ms")
    hub_idx = torch.where(g2.idx < 0, 0, g2.idx).reshape(N2, -1)
    hub_c = torch.randn((*hub_idx.shape, 3), device=dev)
    print(f"  config 2 ball gather with padded slots sent to row 0: "
          f"{int((g2.idx < 0).sum())} padded slots, longest segment "
          f"{longest_segment(hub_idx, P2c)}, "
          f"{cuda_ms(lambda: scatter_rows(hub_idx, hub_c, P2c), reps=10):.4f} ms")
    for label, cloud, K in (("1M", big1, 1024), ("4M", big4, 512)):
        one = T(np.array([cloud.shape[1]]), torch.int64)
        ref = kf.fps_plain(cloud, one, T(np.array([K]), torch.int64),
                           T(np.array([0]), torch.int64), K)
        require(torch.equal(big_idx[label], ref), f"FPS {label}: idx differ from plain")
    print("  large-cloud FPS vs plain: idx equal (1M K=1024, 4M K=512)")

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
    outk = kc.chamfer_nn_cuda(x3, y3, l3x, l3y, 2)
    outp = kc.chamfer_nn_plain(x3, y3, l3x, l3y, 2)
    for a, b, ia, ib in ((outk[0], outp[0], outk[1], outp[1]),
                         (outk[2], outp[2], outk[3], outp[3])):
        require(torch.equal(torch.isinf(a), torch.isinf(b)),
                "chamfer_nn config 3: inf pattern")
        fin = torch.isfinite(a)
        err = (a[fin] - b[fin]).abs().max().item()
        note_err("chamfer", err)
        require(err <= TOL, f"chamfer_nn config 3: err {err}")
        require(torch.equal(ia, ib), "chamfer_nn config 3: idx")
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
    # call is also timed step by step (CUDA events recorded between its
    # launches): the sort is every step but the segment sum.
    k1_idx = torch.where(torch.arange(P3, device=dev)[None] < l3x[:, None], outk[1], -1)
    for key, wrapper, idx, P2 in (
        ("rows", ks.scatter_add_rows, ns_sub[1].reshape(1, -1), 100000),
        ("k1", ks.scatter_add_k1, k1_idx, P3),
    ):
        N, E = idx.shape
        contrib = torch.randn((N, E, 3), device=dev)
        plan, ref_plan = ks.sort_plan(idx, P2), ks.segment_plan(idx, P2)
        require(torch.equal(plan[0], ref_plan[0]) and torch.equal(plan[1], ref_plan[1]),
                f"sort_plan at the {key} main path's shape")
        out1 = wrapper(idx, contrib, P2)
        out2 = wrapper(idx, contrib, P2)
        err = (out1 - ks.scatter_add_plain(idx, contrib, P2)).abs().max().item()
        require(torch.equal(out1, out2), f"scatter {key} at the main path's shape: "
                "not bit-equal")
        note_err(key, err)
        require(err <= TOL, f"scatter {key} at the main path's shape: err {err}")
        ms = cuda_ms(lambda: wrapper(idx, contrib, P2), reps=10)
        steps = scatter_steps(idx, contrib, P2)
        print(f"  scatter_add_{key} {N}x{E} into {P2} rows: sort "
              f"{sum(steps.values()) - steps['segment sum']:.4f} ms + segment sum "
              f"{steps['segment sum']:.4f} ms; per launch (ms) "
              f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}")
        plain_ms = cuda_ms(lambda: ks.scatter_add_plain(idx, contrib, P2), reps=10)
        rows = torch.where(
            idx >= 0, idx + torch.arange(N, device=dev)[:, None] * P2, N * P2
        ).reshape(-1)
        flat = contrib.reshape(-1, 3)
        lib_out = torch.zeros((N * P2 + 1, 3), device=dev)
        library_ms = cuda_ms(lambda: lib_out.index_add_(0, rows, flat), reps=10)
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
            library_ms=library_ms,
        ))

    # A skewed input: one row receives 100,000 of 200,000 entries. The
    # segment sum gives every row one thread, so that row is one serial sum.
    skew_idx = T(rng.integers(0, 100000, size=(1, 200000)), torch.int64)
    skew_idx[0, ::2] = 7
    skew_c = torch.randn((1, 200000, 3), device=dev)
    require(torch.equal(ks.scatter_add_rows(skew_idx, skew_c, 100000).cpu(),
                        ks.scatter_add_plain(skew_idx.cpu(), skew_c.cpu(), 100000)),
            "skewed scatter: not bit-equal to the CPU twin")
    skew_ms = cuda_ms(lambda: ks.scatter_add_rows(skew_idx, skew_c, 100000), reps=5)
    skew_steps = scatter_steps(skew_idx, skew_c, 100000, reps=5)
    print(f"  skewed scatter (100,000 of 200,000 entries on one of 100,000 rows): "
          f"{skew_ms:.4f} ms; per launch (ms) "
          f"{json.dumps({k: round(v, 4) for k, v in skew_steps.items()})}")

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
    print("timed shapes: knn_topk 1 x 100000 x 100000 K=16 D=3; chamfer_nn_bidir "
          "16 x 10000 (ragged 9000-10000) D=3; scatter_add_rows E=1,600,000 "
          "into 100000 x 3; scatter_add_k1 E=16 x 10000 into 16 x 10000 x 3; "
          "ball_query 32 x 512 queries vs 32 x 4096 (ragged 3500-4096) K=32 "
          "r=0.2; fps_batched 32 x 4096 (ragged) K=512; fps_resident 1 x "
          "1,000,000 K=1024; fps_streaming 1 x 4,000,000 K=512; all D=3")

    print(json.dumps({"kernels": records}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
