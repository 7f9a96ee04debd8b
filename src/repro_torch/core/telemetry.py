"""Training-plane integrations of the mergeable-histogram primitive.

PyTorch port of ``repro.core.telemetry``.  Every class and function takes
a ``device`` (``None`` → the card, raising without one; ``"cpu"`` runs the
kernels' plain versions; a tensor stays where it lies) and hands it to the
registry and to ``build_exact``/``merge``.  A tree of tensors is a nested
dict, list or tuple (:mod:`repro_torch.tree`), its leaves named and
ordered as ``jax.tree_util`` names and orders them.

The paper's motivating statistic is "p95 latency over all servers for any
time window".  A large training job needs exactly that class of query over
four data planes, all served by the same summarize→merge machinery:

  1. gradient / activation distributions   (blowup & underflow monitoring)
  2. quantile gradient clipping             (optim/ uses ``grad_clip_value``)
  3. histogram-threshold gradient sparsification (optim/compression.py)
  4. per-host step-time stragglers          (``StragglerDetector``)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.distributed import tensor_histogram_in_step
from repro_torch.core.histogram import (
    Histogram,
    _host,
    as_tensor,
    build_exact,
    merge_list,
    quantile,
)
from repro_torch.core.retention import RetentionPolicy
from repro_torch.core.tenant import TenantRegistry
from repro_torch.tree import flatten_with_path

__all__ = [
    "tensor_summary",
    "tree_summaries",
    "grad_quantile",
    "StragglerDetector",
    "TelemetryLog",
    "TelemetryHub",
    "timed",
]


def tensor_summary(
    x,
    T: int = 256,
    *,
    magnitude: bool = True,
    mesh=None,
    axis_names: tuple[str, ...] = (),
    device=None,
) -> Histogram:
    """T-bucket summary of one tensor.

    With a mesh, uses the paper's per-shard summarize + all-gather merge
    (``O(k·T)`` comm); without one, an exact local histogram.
    """
    v = as_tensor(x, device)
    v = torch.abs(v) if magnitude else v
    v = v.to(torch.float32)
    if mesh is not None and axis_names:
        return tensor_histogram_in_step(v, T, T, mesh, axis_names)
    flat = v.reshape(-1)
    return build_exact(flat, min(T, flat.shape[0]))


def tree_summaries(
    tree: Any,
    T: int = 256,
    *,
    mesh=None,
    axis_names: tuple[str, ...] = (),
    magnitude: bool = True,
    device=None,
) -> dict[str, Histogram]:
    """Per-leaf summaries of a tree (e.g. the gradient tree), keyed by
    ``jax.tree_util.keystr`` of each leaf's path, in JAX's leaf order."""
    out = {}
    for name, leaf in flatten_with_path(tree):
        out[name] = tensor_summary(
            leaf, T, magnitude=magnitude, mesh=mesh, axis_names=axis_names, device=device
        )
    return out


def grad_quantile(
    grads: Any,
    q: float,
    T: int = 512,
    *,
    mesh=None,
    axis_names: tuple[str, ...] = (),
    device=None,
) -> torch.Tensor:
    """Approximate q-quantile of |g| over the whole gradient tree, a 0-d
    tensor where the gradients lie (no host sync).

    Per-leaf summaries are *merged* (not averaged) — Theorem 1 bounds the
    rank error of the returned threshold by ``2/T`` of the total count, which
    is what makes quantile clipping and top-ρ compression principled instead
    of heuristic.  Cost: one tiny all-gather per leaf, no global sort.
    """
    per_leaf = tree_summaries(
        grads, T, mesh=mesh, axis_names=axis_names, magnitude=True, device=device
    )
    hs = list(per_leaf.values())
    merged = merge_list(hs, max(h.sizes.shape[-1] for h in hs))
    b = merged.boundaries  # q made where it is used: no host-to-device copy
    return quantile(merged, torch.full((), q, dtype=torch.float32, device=b.device))


@dataclass
class StragglerDetector:
    """Flags hosts whose step time exceeds the merged-histogram median ×
    tolerance.

    Each host ingests its own recent step times (a "partition" in paper
    terms); ``flag()`` merges all host summaries (the paper's Merger over
    per-host summaries) and returns hosts whose recent mean exceeds
    ``tolerance ×`` the merged ``quantile_q`` step time.  The reference
    quantile defaults to the *median*: a straggling host carries 1/k of the
    merged mass, so any quantile above ``1 - 1/k`` would be set by the
    straggler itself and mask it.  The trainer reports flags each log
    interval (and a deployment would shrink the host's data share).
    """

    window: int = 64
    T: int = 64
    quantile_q: float = 0.5
    tolerance: float = 1.5
    # where the summaries are built and merged (None → the card)
    device: Any = None
    _times: dict[int, list[float]] = field(default_factory=dict)

    def record(self, host_id: int, step_seconds: float) -> None:
        buf = self._times.setdefault(int(host_id), [])
        buf.append(float(step_seconds))
        if len(buf) > self.window:
            del buf[: len(buf) - self.window]

    def flag(self) -> tuple[list[int], float]:
        """Returns (straggler host ids, global q-quantile step time)."""
        hosts = [h for h, b in self._times.items() if len(b) >= 4]
        if len(hosts) < 2:
            return [], float("nan")
        hs = []
        for h in hosts:
            v = np.asarray(self._times[h], dtype=np.float32)
            hs.append(build_exact(v, min(self.T, v.shape[0]), device=self.device))
        merged = merge_list(hs, max(h.sizes.shape[-1] for h in hs))
        cut = float(quantile(merged, np.float32(self.quantile_q)))
        flagged = [
            h
            for h in hosts
            if float(np.mean(self._times[h][-8:])) > self.tolerance * cut
        ]
        return flagged, cut


@dataclass
class TelemetryLog:
    """Host-side ring of per-step scalar statistics + histogram snapshots."""

    capacity: int = 1024
    scalars: dict[str, list[tuple[int, float]]] = field(default_factory=dict)
    snapshots: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)

    def log_scalar(self, name: str, step: int, value: float) -> None:
        buf = self.scalars.setdefault(name, [])
        buf.append((int(step), float(value)))
        if len(buf) > self.capacity:
            del buf[: len(buf) - self.capacity]

    def log_histogram(self, name: str, step: int, hist: Histogram) -> None:
        self.snapshots[f"{name}@{step}"] = {
            "boundaries": _host(hist.boundaries),
            "sizes": _host(hist.sizes),
        }

    def last(self, name: str) -> float:
        return self.scalars[name][-1][1]


@dataclass
class TelemetryHub:
    """Many named metric streams through ONE multi-tenant registry.

    The serving-plane counterpart of :class:`TelemetryLog`: every metric
    (a gradient leaf's magnitudes, a host's step times, a service's
    latencies) is a *tenant* of a shared :class:`TenantRegistry`, and
    every window of raw samples (a step range, a day) is a partition —
    so one registry answers "p95 of ANY metric over ANY window" with
    per-metric stores, per-metric LRU caches, and a whole dashboard of
    cross-metric panels in a single merge dispatch
    (``TenantRegistry.query_many``).

    ``async_record=True`` routes samples through the registry's shared
    worker pool — the trainer thread only enqueues; call :meth:`flush`
    before reading fresh windows.

    A long-running trainer records windows forever, so the hub forwards
    the registry's bounded-memory knobs (core/retention.py): ``retention``
    ages every metric's old windows out (e.g. ``SlidingWindow(256)`` keeps
    the last 256 step-windows per metric), ``budget`` caps total node
    floats across ALL metrics with fair per-metric quotas.
    ``shared_arena=True`` pools every metric's tree nodes into one
    registry-owned arena (core/arena.py) — dashboards then assemble their
    cross-metric merge stacks with a single device gather.
    """

    T: int = 128
    async_record: bool = False
    registry: TenantRegistry = None
    retention: RetentionPolicy | None = None
    budget: int | None = None
    shared_arena: bool = False
    # durable ingest: a directory path gives the hub's registry a
    # write-ahead log — recorded windows survive a trainer crash between
    # record() and checkpoint() (core/workers.py WAL design note)
    wal_dir: str | None = None
    # where the hub's own registry summarizes and merges (None → the
    # card); an explicit registry carries its own
    device: Any = None

    def __post_init__(self) -> None:
        if self.registry is None:
            self.registry = TenantRegistry(
                num_buckets=self.T,
                retention=self.retention,
                budget=self.budget,
                shared_arena=self.shared_arena,
                wal_dir=self.wal_dir,
                device=self.device,
            )
        elif (
            self.retention is not None
            or self.budget is not None
            or self.wal_dir is not None
        ):
            # an explicit registry carries its own knobs — silently
            # ignoring these would unbound the memory (or void the
            # durability) they promise
            raise ValueError(
                "pass retention/budget/wal_dir to the explicit "
                "TenantRegistry, not to TelemetryHub"
            )

    def record(self, metric: str, partition_id: int, values) -> None:
        """Summarize one window of raw samples for the named metric."""
        if self.async_record:
            self.registry.ingest_async(metric, partition_id, values)
        else:
            self.registry.ingest(metric, partition_id, values)

    def flush(self) -> None:
        self.registry.flush()

    def close(self) -> None:
        self.registry.close()

    def metrics(self) -> list[str]:
        return self.registry.names()

    def wal_stats(self) -> dict | None:
        """Durable-ingest telemetry: WAL depth (records appended but not
        yet applied), fsync count/latency, and byte/segment footprint —
        ``None`` when the hub's registry runs without a log."""
        return self.registry.wal_stats()

    def health(self) -> dict:
        """Serving-plane health aggregate: breaker/quarantine states,
        degraded-answer and backpressure counters (including the last
        backpressure reject's retry-after hint), WAL/pool stats, last
        recovery/scrub reports, and — when a :class:`Replicator` is
        attached to the registry — replication ship counters
        (``TenantRegistry.health``)."""
        return self.registry.health()

    def quantile(
        self, metric: str, lo: int, hi: int, q, beta: int | None = None
    ):
        """q-quantile of one metric over windows ``lo..hi`` (paper-style:
        'p95 latency for any interval', now for any of N metrics)."""
        return self.registry[metric].quantile_query(lo, hi, q, beta)

    def dashboard(
        self,
        panels: "list[tuple[str, int, int]]",
        beta: int = 64,
    ) -> list[tuple[Histogram | None, float]]:
        """Answer a whole dashboard — ``[(metric, lo, hi), ...]`` — with at
        most one cross-tenant merge dispatch; missing metrics/windows come
        back as the ``(None, inf)`` placeholder instead of failing the
        refresh."""
        return self.registry.query_many(panels, beta, strict=False)

    def subscribe(
        self,
        metric: str,
        lo: int,
        hi: int,
        beta: int = 64,
        *,
        policy: str = "coalesce",
        queue_cap: int = 8,
    ):
        """Standing dashboard panel: instead of re-polling
        :meth:`dashboard`, receive pushed ``Update``s whenever windows
        ``lo..hi`` of the metric go stale (serve/subscriptions.py) —
        same hist/eps the pull path reports, one merge dispatch per
        ingest tick across every subscription on the hub."""
        # local import: serve/ imports core/, not the other way around
        from repro_torch.serve.subscriptions import SubscriptionPlane

        planes = self.registry._stale_listeners
        plane = planes[0] if planes else SubscriptionPlane(self.registry)
        return plane.subscribe(
            metric, lo, hi, beta, policy=policy, queue_cap=queue_cap
        )

    def unsubscribe(self, sub) -> None:
        sub.plane.unsubscribe(sub)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def timed(fn: Callable) -> Callable:
    """Decorator: returns (result, wall_seconds); feeds StragglerDetector.
    The clock stops after the devices of the result's CUDA tensors have
    finished; a result held on the host waits for no device."""

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    return wrapper
