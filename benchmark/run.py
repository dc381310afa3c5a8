"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell is
``benchmark/workloads/<cell>.json``; ``benchmark/README.md`` says what each
file holds. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also close standard error.

Exits 3 without a result when there is no CUDA card or fewer cards than
the cell asks for, and 4 when a JAX module is loaded once the window has
closed. The port builds its kernels into
``build/`` at the checkout root; the caches of PyTorch's extensions and of
Triton are pointed there too.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: cell {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device=torch.device("cuda", 0), t_start=T_START, log=log)
    found = harness.forbidden_modules(sys.modules)
    if found:
        log(f"run: forbidden modules loaded: {', '.join(found)}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
