"""Readings that set the limits of a cell's check, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--seconds 2] [--first-seed N]
        [--out FILE]

In one process: the program (``harness.run_cell``, a short window) on
``--seeds`` seeds, whose largest reading of each compared number is its
lower reading; the control (the plain reference in TF32 in the program's
place, ``pipeline.control``) on ``--control-seeds`` seeds; and each of the
pipeline's ``FAULTS`` planted in the port (``pipeline.plant``) on
``--fault-seeds`` seeds. Every reading is judged against the
configuration's ``limits`` as a run judges its own (``harness.judged``):
the program's readings must come out correct, the control's and the
faults' not. Each reading is one JSON line (to ``--out`` and standard
output) with ``correct`` and the numbers over their limits (``failing``);
the summary gives, per number, the lower reading, the least control
reading and the least reading of each fault, and per mode how many
readings came out correct. Benchmark runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_SEED = 3_000_000_019


def over(checks: dict) -> list[str]:
    """The compared numbers that read above their limits."""
    return sorted(k for k, c in checks.items() if c["value"] > c["limit"])


def readings(cell_name: str, seeds: int, control_seeds: int, fault_seeds: int,
             seconds: float, device, bench_dir=None, emit=print,
             first_seed: int = FIRST_SEED) -> list[dict]:
    import torch

    from benchmark import clouds, harness

    bench_dir = bench_dir or harness.BENCH_DIR
    cell = harness.find_cell(cell_name, bench_dir)
    pipe = harness.load_module(bench_dir, "pipelines", cell.config["pipeline"])
    ref = harness.load_module(bench_dir, "reference", cell.config["reference"])
    import pytorch3d_pointops_tpu_torch as port

    out = []

    def note(mode, seed, numbers, **extra):
        line = {"cell": cell_name, "mode": mode, "seed": seed, "numbers": numbers, **extra}
        out.append(line)
        emit(json.dumps(line))

    def run(seed):
        r = harness.run_cell(cell, seed, seconds, False, device=device,
                             t_start=time.perf_counter(), bench_dir=bench_dir,
                             log=lambda s: print(s, file=sys.stderr))
        return {k: c["value"] for k, c in r["checks"].items()}, r

    for k in range(seeds):
        seed = first_seed + k
        numbers, r = run(seed)
        note("program", seed, numbers, correct=r["correct"], failed=r["failed"],
             failing=over(r["checks"]),
             attempted=r["attempted"], step_ms=r["metrics"].get("step_ms", {}).get("value"))
    for k in range(control_seeds):
        seed = first_seed + 1000 + k
        dev_gen, host_gen = clouds.generators(seed, device)
        inputs = pipe.make_inputs(cell.spec["traffic"], dev_gen, host_gen, device)
        t0 = time.perf_counter()
        numbers = pipe.control(inputs, ref, host_gen)
        seconds_taken = time.perf_counter() - t0
        checks, within = harness.judged(numbers, cell.config["limits"])
        note("control", seed, numbers, correct=within,
             failing=over(checks),
             seconds=seconds_taken)
        del inputs
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for name in pipe.FAULTS:
        for k in range(fault_seeds):
            seed = first_seed + 2000 + k
            with pipe.plant(name, port):
                numbers, r = run(seed)
            note(f"fault:{name}", seed, numbers, correct=r["correct"], failed=r["failed"],
                 failing=over(r["checks"]))
    return out


def summary(lines: list[dict]) -> dict:
    """Per compared number, the lower reading (the program's largest) and
    each other mode's least; under ``correct``, per mode, how many of its
    readings came out correct against the configuration's limits."""
    by_mode: dict = {}
    for line in lines:
        by_mode.setdefault(line["mode"], []).append(line)
    out = {}
    for name in lines[0]["numbers"]:
        row = {}
        for mode, rows in by_mode.items():
            vals = [r["numbers"][name] for r in rows]
            row["lower" if mode == "program" else mode] = max(vals) if mode == "program" else min(vals)
        out[name] = row
    out["correct"] = {mode: f"{sum(bool(r['correct']) for r in rows)} of {len(rows)}"
                      for mode, rows in by_mode.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED,
                    help="the program's seeds follow it; the control's from +1000, the faults' from +2000")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    sink = open(args.out, "a") if args.out else None
    try:
        def emit(s):
            print(s, flush=True)
            if sink:
                sink.write(s + "\n")
                sink.flush()

        lines = readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds,
                         args.seconds, torch.device("cuda", 0), emit=emit,
                         first_seed=args.first_seed)
        emit(json.dumps({"cell": args.workload, "summary": summary(lines),
                         "card": torch.cuda.get_device_name(0)}))
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
