"""The port's spans and counters: where a call into the port keeps the host.

Spans mark the port's layers (``PERF.md`` §3): each public op and
``Pointclouds.update_padded``, each autograd Function's backward
(``<Function>.bwd``), the stages of the KNN forward (``knn.sort``,
``knn.bounds``, ``knn.rounds``, ``knn.screen``, ``knn.repair``), each kernel wrapper call
(``knn_topk``, ``chamfer_nn``, ``scatter``, ``ball_query_points``,
``fps``), and the stages of the PointNet++ model (``models/pointnet2.py``):
``pointnet2.plan`` (FPS and ball query of both sampled levels, their op
spans inside it), ``pointnet2.group``, ``pointnet2.mlp`` and
``pointnet2.pool`` once a set-abstraction level, and ``pointnet2.head``,
and those of the Point Transformer (``models/point_transformer.py``):
``point_transformer.plan`` (FPS and the KNN of every level, their op spans
inside it), ``point_transformer.down`` each ``TransitionDown``,
``point_transformer.attn`` each attention layer, ``point_transformer.up``
each ``TransitionUp``, and ``point_transformer.head``, and those of the
Point Transformer V2 (``models/point_transformer_v2.py``):
``point_transformer_v2.plan`` (the grid pooling of every level and its KNN,
their op spans inside it), ``point_transformer_v2.pool`` each grid pooling
of features, ``point_transformer_v2.attn`` each grouped vector attention,
``point_transformer_v2.unpool`` each unpooling, and
``point_transformer_v2.head``; the grid pooling op's ``grid_pool`` (the
coordinates' clusters) and ``grid_pool_max`` (the features' maximum), and
its backward's ``GridPool.bwd``.
Counters name what they count: ``sync.<site>`` each read of tensor values
to the host (whatever the tensor's device, so a CPU run counts what the
card would; ``sync.grid_pool.counts`` a pooling's clusters by cloud, one
read a pooling), ``launch.<wrapper>`` each launch of a hand-written kernel
(``knn_topk_cuda``, ``knn_screen_order_cuda``, ``knn_screen_cuda``,
``knn_select_cuda``, ``chamfer_nn_cuda``, ``scatter_add_rows``,
``scatter_add_k1``, ``ball_query_cuda``, ``fps_batched``,
``fps_clustered``, ``fps_resident``, ``fps_streaming``, ``segment_keys``,
``segment_bounds``, ``segment_sum``, ``segment_max``,
``segment_max_backward``),
``chamfer.rescan_points`` the points whose nearest-neighbour index the
chamfer kernel finds by its rescan (N x (P1 + P2) a D = 3 launch),
``point_transformer.grouped_rows`` the (point, neighbour) rows a Point
Transformer forward gathers (from the host lengths alone),
``point_transformer_v2.grouped_rows`` the rows a Point Transformer V2
forward gathers (each attention's (point, neighbour) rows and each
unpooling's points, from host lengths), and ``grid_pool.clusters`` the
clusters a pooling makes (from the counts it has read, no further read).

Off by default. ``span(name)`` then returns a shared null context after one
flag read, and ``count(name, n)`` adds to a plain dict under a lock
(``counts()``), which is all either does. Recording is on while ``torch.profiler`` records (the
profiler's own module flag) and inside ``recording()``. A span that is on
keeps a ``Record`` in memory, stamped with ``time.time_ns()``, the clock
the profiler stamps its host events with; under the profiler it also opens
a ``record_function`` range named ``ppt.<name>``, so any trace of a user's
own shows the port's stages. A counter that is on also adds to the innermost
open span of its thread (``Record.counts``); one made outside every span is
only in ``counts()``.

Nesting is per thread: the autograd engine runs backwards on a thread of its
own on the card. At most ``MAX_RECORDS`` records are kept; later ones are
counted in ``dropped()``. Reading the records does not clear them;
``clear()`` does, with the counters.

A Chrome trace exported by the profiler gives host times in microseconds
from ``baseTimeNanoseconds``: a record's ``start_ns`` is at
``(start_ns - base) / 1e3`` there (``trace_us``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

PREFIX = "ppt."
MAX_RECORDS = 200_000

# The interval to which the profiler's Chrome export floors its base time
# (libkineto's ChromeTraceBaseTime; ``torch/profiler/_chrome_trace_export.py``).
TRACE_BASE_SECONDS = 7_889_238


class Record(NamedTuple):
    """One span: ``id`` and ``parent`` (the id of the span it opened in on
    the same thread, or None), ``thread`` (``threading.get_ident()``),
    host ``start_ns``/``end_ns`` (``time.time_ns()``) and ``counts``, the
    counter increments made while it was the innermost open span."""

    id: int
    name: str
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int
    counts: dict


_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}
_records: list[Record] = []
_dropped = 0
_recording = 0  # open recording() contexts
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()  # the backwards count on the autograd engine's thread


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "counts", "start_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.counts = {}
        stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        _keep(Record(self.id, self.name, self.parent, threading.get_ident(),
                     self.start_ns, end_ns, self.counts))
        return False


def _keep(record: Record) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(record)
        else:
            _dropped += 1


def span(name: str):
    """A context that records span ``name`` while recording is on."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_recording or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and, while recording, to the innermost
    open span of this thread)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    if _recording or _profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n


def sync(site: str, n: int = 1) -> None:
    """Count ``n`` reads of tensor values to the host at ``site``."""
    count("sync." + site, n)


def launch(wrapper: str, n: int = 1) -> None:
    """Count ``n`` launches of a hand-written kernel by ``wrapper``."""
    count("launch." + wrapper, n)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside this context, without the profiler
    (and without ``record_function`` ranges)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def counts(prefix: str = "") -> dict[str, int]:
    """The counters whose names start with ``prefix``, since the last
    ``clear()``."""
    with _lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def records() -> list[Record]:
    """The spans recorded since the last ``clear()``, in the order they
    closed."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept since the last ``clear()``: past ``MAX_RECORDS``."""
    return _dropped


def clear() -> None:
    """Forget every record and reset every counter."""
    global _dropped
    with _lock:
        _records.clear()
        _counts.clear()
        _dropped = 0


def trace_base_ns(at_s: float | None = None) -> int:
    """The base time, in epoch ns, of a Chrome trace the profiler exports
    at epoch second ``at_s`` (default now)."""
    at = int(time.time() if at_s is None else at_s)
    return at // TRACE_BASE_SECONDS * TRACE_BASE_SECONDS * 1_000_000_000


def trace_us(t_ns: int, base_ns: int) -> float:
    """A ``time.time_ns()`` stamp on a Chrome trace's time axis (us)."""
    return (t_ns - base_ns) / 1e3
