"""Windowed retention: TTL / sliding-window / memory-budget policies.

The paper's framework answers queries "for a given time interval", but the
summary store it implies is append-only: an infinite stream (a new partition
per day, forever) grows leaf summaries and pre-merged tree nodes without
bound, and old partitions can never leave the store.  This module makes the
time-interval semantics first-class: a :class:`RetentionPolicy` decides, per
sweep, which partitions have left the window, and the store evicts their
leaves (``IntervalTree.evict_leaves`` — ``set_leaf``'s pull-up in reverse,
with lazy subtree collapse) so memory stays bounded for always-on serving.

Watermark semantics
-------------------
Partition ids ARE the time axis (the paper's "days"), so retention is
**watermark-driven, not wall-clock-driven**: the watermark is the highest
partition id ever ingested, it only moves forward, and :class:`TTL` ages
partitions against it.  Replaying a historical stream therefore evicts
exactly what the live stream would have evicted, and a store reloaded from
npz (the watermark persists through ``HistogramStore._state``/``_restore``)
resumes aging where it stopped instead of resurrecting expired partitions.

Policies
--------
* ``TTL(max_age)``           — evict partitions older than ``max_age`` ids
  behind the watermark (keeps ids in ``[watermark - max_age, watermark]``).
* ``SlidingWindow(max_partitions)`` — keep only the newest
  ``max_partitions`` present partitions.
* ``MemoryBudget(max_node_floats)`` — evict oldest partitions until the
  tree's node-float footprint fits the budget (never evicts the newest
  partition, so a single oversized partition cannot livelock the sweeper).
* ``AnyOf(p1, p2, ...)``     — union of victims (e.g. TTL *and* a budget).

Policies are pure: ``victims(stats)`` maps a :class:`StoreStats` snapshot to
the partition ids to evict and never touches the store.  The sweeper
(``HistogramStore.sweep_retention``) re-evaluates until the policy returns
nothing, so ``MemoryBudget`` may converge over a few estimate-driven passes
while TTL/window converge in one.

Memory metering and collapse modes
----------------------------------
``StoreStats.node_floats`` (what :class:`MemoryBudget` meters) counts
*logical* summary floats per unique arena row — layout-independent, so
budget calibrations survive the pooled-arena storage (core/arena.py); the
resident pool size itself is ``NodeArena.allocated_floats`` /
``capacity_floats``.  Under ``HistogramStore(collapse="amortized")`` the
evicted dead prefix lingers until it exceeds half the tree capacity, so
the footprint rides up to one extra tree level above the canonical mode's
before the deferred re-root reclaims it — the sweeper's convergence loop
is unaffected because ``victims`` only ever names present partitions.

Where sweeps run
----------------
Synchronous ingest sweeps inline after each apply; asynchronous ingest runs
the sweeper on the shared ingest worker (core/workers.py ``on_batch_end``)
between flushes, so ``flush()`` returning implies retention has been
enforced on everything visible.  ``TenantRegistry(budget=...)`` adds the
cross-tenant layer: a global node-float budget with fair per-tenant quotas
(evict from the largest-over-quota tenant first) on top of any per-tenant
policy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "StoreStats",
    "RetentionPolicy",
    "TTL",
    "SlidingWindow",
    "MemoryBudget",
    "AnyOf",
    "policy_from_spec",
]


@dataclass(frozen=True)
class StoreStats:
    """Policy-facing snapshot of one store (taken under the store lock)."""

    ids: tuple[int, ...]  # sorted present partition ids
    watermark: int | None  # highest partition id ever ingested
    node_floats: int  # current tree node-float footprint (shared arrays
    #                   counted once — IntervalTree.node_floats)


class RetentionPolicy:
    """Decides which partitions leave the store.  Pure: no store access."""

    def victims(self, stats: StoreStats) -> list[int]:
        """Partition ids to evict given the snapshot (may be re-evaluated
        by the sweeper until it returns an empty list)."""
        raise NotImplementedError

    def spec(self) -> dict:
        """json-able self-description for npz persistence; inverse of
        :func:`policy_from_spec`."""
        raise NotImplementedError


@dataclass(frozen=True)
class TTL(RetentionPolicy):
    """Evict partitions more than ``max_age`` ids behind the watermark."""

    max_age: int

    def __post_init__(self) -> None:
        if self.max_age < 0:
            raise ValueError("max_age must be >= 0")

    def victims(self, stats: StoreStats) -> list[int]:
        if stats.watermark is None:
            return []
        horizon = stats.watermark - self.max_age
        return [p for p in stats.ids if p < horizon]

    def spec(self) -> dict:
        return {"kind": "ttl", "max_age": int(self.max_age)}


@dataclass(frozen=True)
class SlidingWindow(RetentionPolicy):
    """Keep only the newest ``max_partitions`` present partitions."""

    max_partitions: int

    def __post_init__(self) -> None:
        if self.max_partitions < 1:
            raise ValueError("max_partitions must be >= 1")

    def victims(self, stats: StoreStats) -> list[int]:
        k = len(stats.ids) - self.max_partitions
        return list(stats.ids[:k]) if k > 0 else []

    def spec(self) -> dict:
        return {"kind": "window", "max_partitions": int(self.max_partitions)}


@dataclass(frozen=True)
class MemoryBudget(RetentionPolicy):
    """Evict oldest partitions until node floats fit ``max_node_floats``.

    The victim count per pass is an estimate (``need / mean floats per
    partition``) because collapse frees internal nodes non-linearly; the
    sweeper's re-evaluation loop absorbs the estimation error.  The newest
    partition is never a victim.
    """

    max_node_floats: int

    def __post_init__(self) -> None:
        if self.max_node_floats < 1:
            raise ValueError("max_node_floats must be >= 1")

    def victims(self, stats: StoreStats) -> list[int]:
        if stats.node_floats <= self.max_node_floats or len(stats.ids) <= 1:
            return []
        per_part = stats.node_floats / len(stats.ids)
        need = stats.node_floats - self.max_node_floats
        k = min(len(stats.ids) - 1, max(1, math.ceil(need / per_part)))
        return list(stats.ids[:k])

    def spec(self) -> dict:
        return {"kind": "budget", "max_node_floats": int(self.max_node_floats)}


class AnyOf(RetentionPolicy):
    """Union of victims: a partition leaves when ANY member policy says so
    (e.g. ``AnyOf(TTL(30), MemoryBudget(1_000_000))``)."""

    def __init__(self, *policies: RetentionPolicy):
        if not policies:
            raise ValueError("AnyOf needs at least one policy")
        self.policies = tuple(policies)

    def victims(self, stats: StoreStats) -> list[int]:
        out: set[int] = set()
        for p in self.policies:
            out.update(p.victims(stats))
        return sorted(out)

    def spec(self) -> dict:
        return {"kind": "any_of", "policies": [p.spec() for p in self.policies]}

    def __eq__(self, other) -> bool:
        return isinstance(other, AnyOf) and self.policies == other.policies

    def __hash__(self) -> int:
        return hash(self.policies)

    def __repr__(self) -> str:
        return f"AnyOf{self.policies!r}"


def policy_from_spec(spec: dict | None) -> RetentionPolicy | None:
    """Rebuild a policy from its :meth:`RetentionPolicy.spec` dict."""
    if spec is None:
        return None
    kind = spec["kind"]
    if kind == "ttl":
        return TTL(int(spec["max_age"]))
    if kind == "window":
        return SlidingWindow(int(spec["max_partitions"]))
    if kind == "budget":
        return MemoryBudget(int(spec["max_node_floats"]))
    if kind == "any_of":
        return AnyOf(*(policy_from_spec(s) for s in spec["policies"]))
    raise ValueError(f"unknown retention policy kind: {kind!r}")
