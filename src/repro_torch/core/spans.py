"""Named spans and counters of the store's ingest path and its tree upkeep,
and of the served model's Mamba and expert layers.

Every span and counter the port keeps is declared here, in one table,
as ``kernels/_lib.KERNELS`` declares the kernels: :func:`snapshot` always
holds every key, and an undeclared name raises ``KeyError``.

``with span(name):`` adds to three process-wide totals, in integers:
``span_calls.<name>``, ``span_ns.<name>`` (wall time) and
``span_self_ns.<name>`` (wall time less what the span's child spans on
the same thread cover).  Each thread keeps its own stack of open spans;
the totals are shared, so the ingest worker's spans add to the same
figures as the caller's.  Only while a ``torch.profiler`` session runs
does a span also enter ``torch.profiler.record_function(name)``, which
puts it on the device trace's clock; outside one it costs two clock
reads, a flag check and a locked add (``record_function`` alone costs
over ten times that).

:func:`count` adds to a declared counter.  The totals are process-wide,
as ``_lib.LAUNCHES`` is: a reader takes the change between two
snapshots.
"""
from __future__ import annotations

import threading
import time

import torch

__all__ = ["COUNTERS", "SPANS", "count", "snapshot", "span"]

# span name -> what it covers (one span a phase of a call, never a row)
SPANS = {
    # the Summarizer: a synchronous ``ingest``/``ingest_many``, or one
    # batch an ingest worker drained
    "store.ingest": "the whole ingest call or worker batch",
    "store.validate": "flattening and the empty-partition check",
    "store.wal": "the write-ahead log's append and fsync",
    "store.pad": "narrowing to 32 bits, grouping, and the sort's input buffer: its allocation and sentinel fill",
    "store.stack": "a dispatch's lengths and its duplicated rows",
    "store.h2d": "each row's copy from the caller's array into the sort's input buffer",
    "store.sort": "the row sort's launch side (build_exact_padded_batched)",
    "store.d2h": "boundaries and sizes back to the host, the sort's wait included",
    "store.tree_update": "leaf writes and pull-up merges",
    "store.retention": "the retention sweep: evictions and collapse",
    # the model (models/), one span a layer's call
    "model.mamba": "a Mamba mixer's prefill call: projections, convolution, scan, output",
    "mamba.scan": "a Mamba mixer's chunked scan from its post-conv x1 to y: the Δ, B and C products and norms, the scan",
    "model.moe": "an expert layer's call: routing, dispatch, the expert products, the combine",
}

# counter name -> what it counts
COUNTERS = {
    "ingest.padded_values": "values the row sort receives beyond the real ones: pad sentinels and duplicated rows",
    "ingest.host_copy_bytes": "bytes of host staging arrays ingest writes: the narrowing copy, mixed-dtype casts, contiguous copies (and pad_pow2's arrays, where a caller pads)",
    "ingest.upload_bytes": "bytes ingest copies from host arrays into the sort's input buffer",
    "ingest.pinned_bytes": "the part of ingest.upload_bytes that goes through a device's pinned staging ring",
    "pullup.dispatches": "batched merge dispatches of the tree's pull-ups and rebuilds",
    "pullup.pair_merges": "sibling pairs those dispatches merged",
    "moe.routed_slots": "token-slots an expert layer routed: real tokens times the experts a token",
    "moe.expert_rows": "rows the expert products computed, padding and empty capacity places included",
}

# span name -> [calls, ns, self ns]; counter name -> [total]
_SPAN_TOTALS = {name: [0, 0, 0] for name in SPANS}
_COUNTER_TOTALS = {name: [0] for name in COUNTERS}
_LOCK = threading.Lock()
_profiling = torch._C._autograd._profiler_enabled


class _Open(threading.local):
    def __init__(self):
        self.stack: list[span] = []  # this thread's open spans, innermost last


_OPEN = _Open()


class span:
    """``with span(name):`` times one phase (see the module docstring)."""

    __slots__ = ("name", "_totals", "_stack", "_t0", "_child", "_annotation")

    def __init__(self, name: str):
        totals = _SPAN_TOTALS.get(name)
        if totals is None:
            raise KeyError(f"undeclared span {name!r}")
        self.name, self._totals = name, totals

    def __enter__(self) -> "span":
        stack = self._stack = _OPEN.stack
        stack.append(self)
        self._child = 0
        self._annotation = None
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        stack = self._stack
        stack.pop()
        if stack:
            stack[-1]._child += ns
        totals = self._totals
        with _LOCK:
            totals[0] += 1
            totals[1] += ns
            totals[2] += ns - self._child
        return False


def count(name: str, n: int) -> None:
    """Add ``n`` to the declared counter ``name``."""
    totals = _COUNTER_TOTALS.get(name)
    if totals is None:
        raise KeyError(f"undeclared counter {name!r}")
    with _LOCK:
        totals[0] += int(n)


def snapshot() -> dict[str, int]:
    """Every span total and counter, process-wide, as they stand:
    ``span_calls.<span>``, ``span_ns.<span>``, ``span_self_ns.<span>``
    and ``<counter>``."""
    with _LOCK:
        out = {}
        for name, (calls, ns, self_ns) in _SPAN_TOTALS.items():
            out[f"span_calls.{name}"] = calls
            out[f"span_ns.{name}"] = ns
            out[f"span_self_ns.{name}"] = self_ns
        out.update((name, total) for name, (total,) in _COUNTER_TOTALS.items())
        return out
