#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (pytorch3d_pointops_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0]

Phase 1 builds the CUDA kernels from ``pytorch3d_pointops_tpu_torch/csrc``
into ``build/`` and prints the card's name and power limit. Phase 2 holds
every kernel against its plain PyTorch twin on the card: ragged lengths,
fully masked clouds, norms 1 and 2, D in {3, 16}, K in {1, 8, 16, 64, 100},
duplicate points on a 1/8 grid so that ties are real, and the scatter run
twice and compared bit for bit. Phase 3 drives the main path at full size
through the public entry points, with every launch counter set to 0 just
before and read just after:

* config 3: ``chamfer_distance`` on two ``Pointclouds`` of 16 x 10,000
  points (ragged 9,000-10,000) with normals and colors, mean/mean, five SGD
  steps of forward and backward;
* config 1: ``knn_points`` on 2 clouds of 1000/800 points, K=8, forward and
  backward;
* north star: ``knn_points`` on 100k x 100k points, K=16, forward and
  backward.

It then checks the main path against the plain path on the card (config 3
loss and feature losses within rel 1e-5, gradients within 1e-5 of their
largest entry; the north-star KNN on a 4,096-query subset), two backward
runs for bit-equality, and times every kernel at the main path's shapes
beside its plain twin, its bound and, for the scatter, ``index_add_``. Each
timed launch is also held against its plain twin at that shape (indices
equal, values within 1e-5) and the scatters run twice for bit-equality. The line before the last is one JSON object
with a record per kernel; the last line is
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
    from pytorch3d_pointops_tpu_torch.kernels import chamfer as kc
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

    stats = {k: {"err": 0.0} for k in ("knn", "chamfer", "rows", "k1")}

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
    for key, wrapper in (("rows", ks.scatter_add_rows), ("k1", ks.scatter_add_k1)):
        for N, E, P2, C in ((3, 4097, 1000, 3), (1, 777, 64, 6), (2, 999, 300, 11)):
            idx = T(rng.integers(-1, P2, size=(N, E)), torch.int64)
            contrib = T(rng.normal(size=(N, E, C)).astype(np.float32))
            out1 = wrapper(idx, contrib, P2)
            out2 = wrapper(idx, contrib, P2)
            ref = ks.scatter_add_plain(idx, contrib, P2)
            torch.cuda.synchronize()
            require(torch.equal(out1, out2), f"scatter {key} {N}x{E}: not bit-equal")
            err = (out1 - ref).abs().max().item()
            note_err(key, err)
            require(err <= TOL, f"scatter {key} {N}x{E}x{C}: err {err}")
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
                 ks.scatter_add_k1)
        kk.knn_topk = kk.knn_topk_plain
        kc.chamfer_nn_bidirectional = kc.chamfer_nn_plain
        ks.scatter_add_rows = ks.scatter_add_k1 = ks.scatter_add_plain
        try:
            yield
        finally:
            (kk.knn_topk, kc.chamfer_nn_bidirectional, ks.scatter_add_rows,
             ks.scatter_add_k1) = saved

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
    # neighbours (grad_p2) and the config 3 x -> y nearest neighbours.
    k1_idx = torch.where(torch.arange(P3, device=dev)[None] < l3x[:, None], outk[1], -1)
    for key, wrapper, idx, P2 in (
        ("rows", ks.scatter_add_rows, ns_sub[1].reshape(1, -1), 100000),
        ("k1", ks.scatter_add_k1, k1_idx, P3),
    ):
        N, E = idx.shape
        contrib = torch.randn((N, E, 3), device=dev)
        out1 = wrapper(idx, contrib, P2)
        out2 = wrapper(idx, contrib, P2)
        err = (out1 - ks.scatter_add_plain(idx, contrib, P2)).abs().max().item()
        require(torch.equal(out1, out2), f"scatter {key} at the main path's shape: "
                "not bit-equal")
        note_err(key, err)
        require(err <= TOL, f"scatter {key} at the main path's shape: err {err}")
        ms = cuda_ms(lambda: wrapper(idx, contrib, P2), reps=10)
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
    print("timed shapes: knn_topk 1 x 100000 x 100000 K=16 D=3; chamfer_nn_bidir "
          "16 x 10000 (ragged 9000-10000) D=3; scatter_add_rows E=1,600,000 "
          "into 100000 x 3; scatter_add_k1 E=16 x 10000 into 16 x 10000 x 3")

    print(json.dumps({"kernels": records}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
