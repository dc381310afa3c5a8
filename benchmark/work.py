"""The yardstick of the roofline metrics: the work of an op at its shapes,
and the chip's peaks.

Each count is a function of the cell's shapes and lengths only, never of
the kernels that implement the op, so a later change that fuses, splits or
renames kernels is held to the same least time. Counts are float32
operations outside the tensor cores and bytes of HBM traffic, each input
byte read once and each output byte written once.

``least_s`` is the larger of operations over the peak rate and bytes over
the peak bandwidth. Peaks are NVIDIA's data sheet for the H100 SXM part
(dense, no sparsity, at its 700 W limit); a card of another kind has no
entry, and the roofline metrics then read nothing.
"""

from __future__ import annotations

from . import trace

F32 = 4
I64 = 8

PEAKS = {
    # kind prefix: (float32 FLOP/s outside the tensor cores, HBM bytes/s)
    "NVIDIA H100": (67e12, 3.35e12),
}


def peaks(kind: str):
    """(flop/s, bytes/s) for a card's name, or None."""
    for prefix, value in PEAKS.items():
        if kind.startswith(prefix):
            return value
    return None


def least_s(ops: float, nbytes: float, peak) -> float:
    flops, bw = peak
    return max(ops / flops, nbytes / bw)


def knn_forward(lengths1, lengths2, dim: int, k: int) -> dict:
    """KNN forward over padded clouds: 3D - 1 arithmetic operations and one
    comparison a valid (query, point) pair; the valid points of both
    clouds read once; (dist float32, idx int64) for K slots of every
    valid query written once."""
    pairs = sum(a * b for a, b in zip(lengths1, lengths2))
    queries, points = sum(lengths1), sum(lengths2)
    return {"ops": 3 * dim * pairs,
            "bytes": F32 * dim * (queries + points) + (F32 + I64) * k * queries}


def chamfer_forward(lengths_x, lengths_y, dim: int, channels: int) -> dict:
    """Both nearest-neighbour directions of a chamfer loss from one distance
    a valid pair: 3D - 1 operations and two comparisons; the valid points
    and their ``channels`` feature values read once on each side; the
    nearest index (int64) of every valid point of both sides written
    once (the losses are scalars)."""
    pairs = sum(a * b for a, b in zip(lengths_x, lengths_y))
    points = sum(lengths_x) + sum(lengths_y)
    return {"ops": (3 * dim + 1) * pairs,
            "bytes": F32 * (dim + channels) * points + I64 * points}


def knn_backward(lengths1, lengths2, dim: int, k: int) -> dict:
    """KNN backward into both clouds: per valid entry the gradient (float32)
    and index (int64) read, D subtractions, D products with 2g and D adds
    into each of the two gradients; both clouds' valid points read once
    and both gradients written once."""
    entries = sum(a * min(k, b) for a, b in zip(lengths1, lengths2))
    points = sum(lengths1) + sum(lengths2)
    return {"ops": 4 * dim * entries,
            "bytes": (F32 + I64) * entries + 2 * F32 * dim * points}


def chamfer_backward(lengths_x, lengths_y, dim: int) -> dict:
    """Chamfer backward into x alone (the gradient a training step asks
    for): per valid point of either side its gradient (float32) and nearest
    index (int64) read, D subtractions, D products with 2g and D adds into
    x's gradient; the valid points of both sides read once and x's gradient
    written once."""
    entries = sum(lengths_x) + sum(lengths_y)
    return {"ops": 3 * dim * entries,
            "bytes": (F32 + I64) * entries + F32 * dim * entries
            + F32 * dim * sum(lengths_x)}


def span_roofline(ctx, op: str):
    """100 x the least time of ``op``'s work over the device time launched
    inside its span, per profiled step; None where the cell has no such
    op, no card in the peak table, or no device time in the span."""
    w = ctx.work.get(op)
    if w is None or ctx.peak is None or ctx.trace is None:
        return None
    device_s = trace.span_device_us(ctx.trace, w["span"]) / 1e6 / ctx.profiled_steps
    if device_s <= 0:
        return None
    return 100.0 * least_s(w["ops"], w["bytes"], ctx.peak) / device_s
