"""Device time of one training step under ``torch.profiler``, beside the
step's wall time: config 2 (PointNet++ grouping) and config 3 (chamfer).

Run from the repository root on a machine with a CUDA card:

    python -m pytorch3d_pointops_tpu_torch.profile_step [--seed 0]

For each step it prints the device's busy time (the sum of its kernels,
copies and fills; one stream, so they do not overlap), the wall time of
the step ended by a synchronize, the share of that wall time the device was
idle, and the longest kernels by name; then the card's name and power
limit. ``chip_smoke.py`` calls ``device_share`` on its own steps. The steps
call only public entry points, so a copy of this file in an older tree's
package profiles that tree's kernels. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch


def device_share(label: str, step) -> dict:
    """Run ``step`` once to warm up, then once under the profiler; print
    and return its device busy ms, kernel ms, wall ms and idle share (None
    when the profiler traced no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        if not e.name.startswith(("Memcpy", "Memset")):
            name = e.name.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void |\(.*$", "", name)[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = 1 - busy / wall if dev_events else None
    print(f"  {label} step under torch.profiler: device busy {busy:.4f} ms "
          f"({sum(by_name.values()):.4f} ms in kernels, {len(dev_events)} device "
          f"activities) of {wall:.4f} ms wall; longest kernels (ms) "
          f"{json.dumps({k: round(v, 4) for k, v in top})}")
    if idle is None:
        print(f"  {label} step: the profiler traced no device activity; idle "
              "share not measured")
    else:
        print(f"  {label} step device idle share: {idle:.4f} "
              f"(busy / wall {busy / wall:.4f})")
    return {"busy_ms": busy, "kernel_ms": sum(by_name.values()), "wall_ms": wall,
            "idle_share": idle}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    import pytorch3d_pointops_tpu_torch as ppt

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    # Config 2: 32 clouds of up to 4,096 points (ragged 3,500-4,096,
    # uniform in the unit ball), FPS K=512, ball query r=0.2 K=32, a loss on
    # the grouped local coordinates and distances, backward.
    d = rng.normal(size=(32 * 4096, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d *= rng.uniform(size=(32 * 4096, 1)) ** (1 / 3)
    pts2 = torch.tensor(d.reshape(32, 4096, 3), dtype=torch.float32, device=dev)
    len2 = torch.tensor(rng.integers(3500, 4097, size=32), device=dev)

    def group_step():
        x = pts2.detach().requires_grad_(True)
        centroids, _ = ppt.sample_farthest_points(x, len2, K=512)
        g = ppt.ball_query(centroids, x, lengths2=len2, K=32, radius=0.2)
        ((g.knn - centroids[:, :, None]).square().sum() + g.dists.sum()).backward()

    # Config 3: chamfer with normals and colors on 16 x 10,000 points
    # (ragged 9,000-10,000), mean/mean, forward and backward.
    def cloud(scale):
        feats = {"normals": rng.normal(size=(16, 10000, 3)).astype(np.float32),
                 "colors": rng.uniform(size=(16, 10000, 3)).astype(np.float32)}
        feats["normals"] /= np.linalg.norm(feats["normals"], axis=-1, keepdims=True)
        return ppt.pointclouds_from_numpy(
            (scale * rng.normal(size=(16, 10000, 3))).astype(np.float32),
            rng.integers(9000, 10001, size=16), feats, device=dev)

    tgt, src = cloud(1.0), cloud(1.5)

    def chamfer_step():
        p = src.points_padded().detach().requires_grad_(True)
        loss, lf = ppt.chamfer_distance(src.update_padded(p), tgt,
                                        feature_names=["normals", "colors"],
                                        point_reduction="mean", batch_reduction="mean")
        (loss + lf["normals"] + lf["colors"]).backward()

    print(f"device: {torch.cuda.get_device_name(0)}")
    device_share("config 2", group_step)
    device_share("config 3", chamfer_step)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
