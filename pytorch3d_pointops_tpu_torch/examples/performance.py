"""Performance tour: KNN, ball query and FPS latency by cloud size, batch
scaling, each kernel against its plain twin at the same inputs (timed, and
its outputs held equal), KNN's peak memory and its empirical complexity
exponent; the port of the JAX
package's ``examples/performance.py`` (the reference's
``cuda_vs_python_performance.py``).

The sizes follow the device asked for: on ``cuda`` the JAX script's TPU
sizes, timed with CUDA events; on ``cpu`` its small ones, timed on the
host's clock. On the CPU every wrapper runs its plain twin, so the kernel
and twin columns time the same code, and there is no memory reading.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch import (
    ball_query,
    knn_points,
    make_device,
    sample_farthest_points,
)
from pytorch3d_pointops_tpu_torch.examples import check, parser
from pytorch3d_pointops_tpu_torch.kernels import ball_query as kb
from pytorch3d_pointops_tpu_torch.kernels import fps as kf
from pytorch3d_pointops_tpu_torch.kernels import knn as kk
from pytorch3d_pointops_tpu_torch.ops.fps import route

SIZES = {"cuda": (1000, 5000, 20000, 50000), "cpu": (500, 1000)}
EXPONENT_SIZES = {"cuda": (2000, 5000, 10000, 20000, 50000), "cpu": (500, 1000, 2000)}
BATCHES = (1, 4, 16, 32)
BALL_K, BALL_R = 20, 0.5
# A kernel's outputs against its twin's: indices equal, values within TOL
# of their largest entry.
TOL = 1e-5


def timeit(fn, dev: torch.device, iters: int = 3):
    """Median ms of ``fn`` over ``iters`` calls after one warm-up (CUDA
    events on the card, the host's clock on the CPU), and its last output."""
    out = fn()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def same_outputs(op: str, P: int, got, want) -> float:
    """Raise unless the kernel's outputs ``got`` are its twin's ``want``;
    returns the largest difference of a value."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{op} at P={P}: output {i} is {g.dtype}{tuple(g.shape)}, the twin's "
              f"{w.dtype}{tuple(w.shape)}")
        if w.is_floating_point():
            err = float((g - w).abs().max()) if w.numel() else 0.0
            scale = float(w.abs().max()) if w.numel() else 0.0
            check(err <= TOL * scale, f"{op} at P={P}: output {i} off the twin's by {err:.3g}")
            worst = max(worst, err)
        else:
            check(torch.equal(g, w), f"{op} at P={P}: output {i} differs from the twin's")
    return worst


def main(device="cuda", seed: int = 0) -> dict:
    dev = make_device(device)
    rng = np.random.default_rng(seed)
    sizes, exp_sizes = SIZES[dev.type], EXPONENT_SIZES[dev.type]
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")

    def cloud(N, P):
        return torch.from_numpy(rng.normal(size=(N, P, 3)).astype(np.float32)).to(dev)

    out = {"knn_ms": {}, "ball_ms": {}, "fps_ms": {}, "batch_ms": {},
           "batch_efficiency": {}, "kernel_vs_plain": [], "peak_mb": None}

    def versus(op, P, kernel, plain):
        (k_ms, got), (p_ms, want) = timeit(kernel, dev), timeit(plain, dev, iters=1)
        err = same_outputs(op, P, got, want)
        out["kernel_vs_plain"].append({"op": op, "P": P, "kernel_ms": k_ms, "plain_ms": p_ms,
                                       "max_abs_err": err})
        print(f"    kernel vs plain twin: {k_ms:8.3f} ms vs {p_ms:9.3f} ms "
              f"({p_ms / k_ms:6.1f}x), outputs equal (values within {err:.3g})")

    print("\n== KNN latency (K=16, batch=1) ==")
    for P in sizes:
        p1, p2 = cloud(1, P), cloud(1, P)
        full = torch.full((1,), P, dtype=torch.int64, device=dev)
        t, _ = timeit(lambda: knn_points(p1, p2, K=16).dists, dev)
        out["knn_ms"][P] = t
        print(f"  P={P:7d}: {t:8.3f} ms   {P / t:10.1f}k queries/s")
        versus("knn_topk", P, lambda: kk.knn_topk(p1, p2, full, 16, 2),
               lambda: kk.knn_topk_plain(p1, p2, full, 16, 2))

    print(f"\n== Ball query latency (r={BALL_R}, K={BALL_K}) ==")
    r2 = kb.squared_radius(BALL_R)
    for P in sizes[:3]:
        p1, p2 = cloud(1, P), cloud(1, P)
        full = torch.full((1,), P, dtype=torch.int64, device=dev)
        t, _ = timeit(lambda: ball_query(p1, p2, K=BALL_K, radius=BALL_R,
                                      return_nn=False).dists, dev)
        out["ball_ms"][P] = t
        print(f"  P={P:7d}: {t:8.3f} ms")
        versus("ball_query", P, lambda: kb.ball_query_points(p1, p2, full, full, BALL_K, r2),
               lambda: kb.ball_query_plain(p1, p2, full, full, BALL_K, r2))

    print("\n== FPS latency (K = 10% of points) ==")
    for P in sizes[:3]:
        pts = cloud(1, P)
        K = max(P // 10, 1)
        fargs = (pts, torch.full((1,), P, dtype=torch.int64, device=dev),
                 torch.full((1,), K, dtype=torch.int64, device=dev),
                 torch.zeros((1,), dtype=torch.int64, device=dev), K)
        t, _ = timeit(lambda: sample_farthest_points(pts, K=K)[1], dev)
        out["fps_ms"][P] = t
        wrapper = route(pts)
        print(f"  P={P:7d}: {t:8.3f} ms   ({wrapper.__name__})")
        versus(wrapper.__name__, P, lambda: (wrapper(*fargs),), lambda: (kf.fps_plain(*fargs),))

    print("\n== Batch scaling (500 points a cloud, K=16) ==")
    base = None
    for N in BATCHES:
        p1, p2 = cloud(N, 500), cloud(N, 500)
        t, _ = timeit(lambda: knn_points(p1, p2, K=16).dists, dev)
        base = base or t / N
        eff = base / (t / N) * 100
        out["batch_ms"][N], out["batch_efficiency"][N] = t, eff
        print(f"  N={N:3d}: {t:8.3f} ms  ({eff:5.1f}% scaling efficiency)")

    # The reference's torch.cuda.max_memory_allocated section: the peak a
    # knn_points(K=32) call allocates beyond what was allocated before it.
    # A streaming kernel's peak follows its output, (P, 32) distances and
    # indices; a dense P x P matrix would be 10 GB at P = 50,000.
    print("\n== KNN memory (K=32) ==")
    if dev.type == "cuda":
        out["peak_mb"] = {}
        print(f"  {'P':>8} {'inputs MB':>10} {'outputs MB':>11} {'call peak MB':>13}")
        for P in sizes:
            p1 = cloud(1, P)
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            res = knn_points(p1, p1, K=32)
            torch.cuda.synchronize(dev)
            peak = (torch.cuda.max_memory_allocated(dev) - before) / 2**20
            out["peak_mb"][P] = peak
            outputs = (res.dists.numel() * 4 + res.idx.numel() * 8) / 2**20
            print(f"  {P:8d} {p1.numel() * 4 / 2**20:10.2f} {outputs:11.2f} {peak:13.2f}")
            del res
    else:
        print("  no reading on the CPU: the peak comes from the CUDA caching allocator")

    # The growth rate of KNN latency between consecutive sizes: O(P^2)
    # work, but small sizes are bound by the launches' fixed cost.
    print("\n== Empirical KNN complexity exponent ==")
    times = []
    for P in exp_sizes:
        p1, p2 = cloud(1, P), cloud(1, P)
        t, _ = timeit(lambda: knn_points(p1, p2, K=16).dists, dev)
        times.append(t)
        print(f"  P={P:7d}: {t:8.3f} ms   t/P={t / P * 1e3:7.3f} us   "
              f"t/P^2={t / P**2 * 1e6:8.4f} ns")
    rates = [float(np.log(times[i] / times[i - 1]) / np.log(exp_sizes[i] / exp_sizes[i - 1]))
             for i in range(1, len(times))]
    out["exponents"] = rates
    out["mean_exponent"] = float(np.mean(rates))
    print(f"  empirical exponent between sizes: {', '.join(f'{r:.2f}' for r in rates)}")
    print(f"  mean O(n^{out['mean_exponent']:.2f}) (brute force is O(n^2); small sizes "
          "are bound by the launches' fixed cost)")
    return out


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(args.device, args.seed)
