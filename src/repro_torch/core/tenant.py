"""Multi-tenant registry: many named HistogramStores, one serving plane.

PyTorch port of ``repro.core.tenant``: the same registry, contracts and
npz schema (``tenant_registry/v1`` — a registry saved by either package
loads in the other).  The registry's ``device`` (``None`` → ``"cuda"``,
raising without a card; ``"cpu"`` runs the kernels' plain versions) is
given to every tenant store and to the shared arena, and the host-packed
cross-tenant merge runs there too — never silently on the CPU.  The
serving planes attach through two hooks: standing-query planes
(serve/subscriptions.py) through ``_stale_listeners`` and a hot-standby
shipper (core/replication.py) through ``_replication``.

A production deployment of the paper's Summarizer/Merger framework tracks
not one metric but thousands — per-service latency, per-table scan sizes,
per-gradient-leaf magnitudes.  One ``HistogramStore`` + ``IntervalTree``
per metric answers each tenant correctly, but N tenants then cost N query
dispatches per dashboard refresh and N independent ingest threads.  The
``TenantRegistry`` keeps the stores (shared configuration, one per named
tenant) and collapses the two hot cross-tenant paths:

Cross-tenant batched queries (one merge launch)
-----------------------------------------------
``query_many([(tenant, lo, hi), ...], beta)`` resolves each query's
canonical segment-tree node set inside its own tenant's tree, then packs
*all* miss selections — across tenants — into one ``(Q, k_pad, T_pad)``
block and answers the whole batch with a single ``merge_stacks`` call,
one batched merge kernel launch (the same free function the per-tree
engine uses; stacking node sets from different trees is sound because
only the summary arrays matter and the shared registry configuration
keeps ``T`` uniform).  Per-tenant LRU answer caches are consulted first and populated
after, exactly like the single-tree ``query_many``, so a repeated
dashboard batch costs zero dispatches.

Consistency: each answer is a consistent snapshot of *its* tenant (node
selection happens under that store's lock); there is no cross-tenant
barrier — two tenants' answers in one batch may reflect different ingest
frontiers, which is the right contract for independent metrics.

Shared async ingest (one worker pool)
-------------------------------------
``ingest_async(tenant, pid, values)`` fans every tenant's partitions into
a single bounded-queue worker pool instead of one thread per store.  Each
drained batch is grouped by tenant and summarized with the store's grouped
one-dispatch summarizer; per-partition failures are isolated (the batch is
retried row by row) and surface on :meth:`flush`, which blocks until
everything enqueued so far is visible.  With ``workers > 1`` partitions
are routed to a worker by a stable hash of the tenant name, so per-tenant
FIFO prefix visibility is preserved (global cross-tenant ordering is not —
again the right contract for independent metrics).

Shared persistence (one npz, atomic)
------------------------------------
``save``/``load`` hold every tenant in a single npz written with the same
mkstemp + fsync + rename discipline as ``HistogramStore.save`` — a crash
leaves either the complete old registry or the complete new one.  Array
keys are namespaced ``t{i}_`` per tenant via ``HistogramStore._state``
(which also carries each tenant's retention watermark).

Durable ingest (``wal_dir=...``)
--------------------------------
One registry-owned write-ahead log covers every tenant: each submitted
partition (sync or async) is appended with its tenant route and fsynced
before the ingest call acks, ``save`` becomes a checkpoint that
truncates covered log segments, and ``recover(path, wal_dir)`` restores
snapshot + uncovered log suffix — so a crash between enqueue and flush
loses nothing that was acked.  Contract details (record layout, group
commit, truncation-on-save, idempotent replay) live in core/workers.py.

Retention and registry-wide memory budgets
------------------------------------------
Two bounded-memory layers compose (core/retention.py):

* ``retention=`` — a per-tenant :class:`RetentionPolicy` shared by every
  store the registry creates (TTL / sliding window / per-store budget);
  the pool worker sweeps the tenants touched by each drained batch
  between flushes, and synchronous ingest sweeps inline.
* ``budget=`` — a **global node-float budget across tenants**.  When the
  summed footprint exceeds it, :meth:`enforce_budget` evicts oldest
  partitions from the **largest-over-quota tenant first** (fair quota =
  budget / #tenants), never below a tenant's newest partition, until the
  registry fits — so thousands of tenants share one bounded memory
  envelope and a single noisy tenant cannot squeeze out the rest.
  Per-tenant footprints are cached per store version, so the steady-state
  check costs O(#tenants) dict lookups, not O(#nodes) scans.

Both planes ride the shared :class:`~repro_torch.core.workers.IngestPool`
(drain/poison-isolation/flush/close live in one place for the store and
the registry).

Shared node-storage arena (``shared_arena=True``)
-------------------------------------------------
Every same-config tenant's tree nodes can pool into ONE registry-owned
:class:`~repro_torch.core.arena.NodeArena` (one device-resident ``(n_slots, T)``
pool pair per row width).  Three hot paths change shape:

* ``query_many`` assembles its cross-tenant merge stack with a **single
  device gather** over the shared pool (zero host-side row copies — the
  ``host_row_copies`` counter machine-checks it) instead of re-packing
  canonical rows host-side per tenant;
* a drained async-ingest batch pulls up **all** touched trees together —
  one merge dispatch per level for the whole batch, not per tenant
  (:func:`~repro_torch.core.interval_tree.pull_up_trees`);
* ``save``/``load`` persist the arena **once per registry** (compacted
  pools + per-tenant slot records) instead of one array dict per tenant.

Answers are bit-identical to the per-tenant-array layout.  Eviction
under concurrent queries stays snapshot-safe because arena rows are
write-once and freed only when their last handle dies — an in-flight pack
holding node handles pins its rows (core/arena.py).
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import ExitStack
from typing import Sequence

import numpy as np

from repro_torch.analysis.witness import OrderedRLock
from repro_torch.core import failpoints as faults
from repro_torch.core import spans
from repro_torch.core.arena import NodeArena
from repro_torch.core.histogram import Histogram
from repro_torch.core.resilience import (
    Answer,
    BreakerPolicy,
    CircuitBreaker,
    TenantQuarantined,
)
from repro_torch.core.scrub import scrub_registry, verify_snapshot
from repro_torch.core.interval_tree import (
    merge_stacks,
    pack_device_rows,
    pack_node_rows,
    pull_up_trees,
    selection_eps,
)
from repro_torch.core.retention import (
    MemoryBudget,
    RetentionPolicy,
    policy_from_spec,
)
from repro_torch.core.stream import (
    HistogramStore,
    _PrefixedArrays,
    _validated,
    atomic_savez,
)
from repro_torch.device import resolve_device
from repro_torch.core.workers import (
    IngestPool,
    PartialBatchFailure,
    PoolStateView,
    WriteAheadLog,
)

__all__ = ["TenantRegistry"]

_SCHEMA = "tenant_registry/v1"


class TenantRegistry(PoolStateView):
    """Many named stores, shared config, one-dispatch cross-tenant serving."""

    def __init__(
        self,
        num_buckets: int,
        *,
        engine: str = "tree",
        T_node: int | str | None = None,
        cache_size: int = 128,
        queue_size: int = 4096,
        workers: int = 1,
        retention: RetentionPolicy | None = None,
        budget: int | None = None,
        shared_arena: bool = False,
        collapse: str = "canonical",
        wal_dir: str | None = None,
        breaker: BreakerPolicy | None = None,
        device=None,
    ):
        if budget is not None and budget < 1:
            raise ValueError("budget must be >= 1 node floats")
        # where every tenant's Summarizer sort and every merge run (module
        # docstring); runtime config, not persisted
        self.device = resolve_device(device)
        self.num_buckets = int(num_buckets)
        self.engine = engine
        self.T_node = T_node
        self.cache_size = int(cache_size)
        self.queue_size = int(queue_size)
        self.workers = int(workers)
        self.retention = retention  # per-tenant policy (shared config)
        self.budget = None if budget is None else int(budget)  # node floats
        self.collapse = str(collapse)  # eviction collapse mode (shared)
        # durable ingest: ONE registry-owned write-ahead log for every
        # tenant (records carry the tenant route) — submits ack only
        # after the record is fsynced, save truncates covered segments,
        # load/recover replay the rest (core/workers.py design note).
        # Tenant stores are created with wal=None: the registry logs.
        self.wal_dir = wal_dir
        self._wal: WriteAheadLog | None = (
            WriteAheadLog(wal_dir) if wal_dir is not None else None
        )
        # stats of the last WAL replay (recover/load), None until then
        self.last_recovery: dict | None = None
        # one registry-owned NodeArena for every tenant's tree nodes: the
        # cross-tenant query_many pack becomes a single device gather over
        # the shared pool, and a drained ingest batch pulls up ALL touched
        # trees with one merge dispatch per level (core/arena.py)
        self.arena: NodeArena | None = (
            NodeArena(self.device) if shared_arena else None
        )
        self._stores: dict[str, HistogramStore] = {}
        self._lock = OrderedRLock("registry._lock")  # tenant dict + caches
        # per-tenant node-float footprints, cached per store version so the
        # budget check is O(#tenants) when nothing changed
        self._floats_cache: dict[str, tuple[int, int]] = {}
        # the shared ingest plane (core/workers.py): drain, poison
        # isolation, enqueue-vs-close serialization, and the retention/
        # budget sweep between flushes all live on the pool
        self._pool = IngestPool(
            apply_batch=self._apply_worker_batch,
            wrap_error=self._wrap_async_error,
            workers=int(workers),
            queue_size=self.queue_size,
            name="tenant-ingest",
            on_batch_end=self._sweep_after_batch,
            wal=self._wal,
            wal_record=lambda item: (item[0], item[1], item[2]),
        )
        # cross-tenant merge dispatch observability (summarize_shapes-style)
        self.merge_dispatches = 0
        self.merge_shapes: set[tuple[int, int, int, int]] = set()
        # ----- self-healing plane (core/resilience.py) -----
        # per-tenant circuit breakers: None → quarantine disabled (the
        # historical contract); a BreakerPolicy (assignable post-load too)
        # trips a tenant whose ingests keep failing, rejecting further
        # submits at the door (TenantQuarantined) until a cooldown probe
        # succeeds — a poisoned tenant cannot keep riding into shared
        # batches.  Breakers are runtime config and are NOT persisted.
        self.breaker_policy = breaker
        self._breakers: dict[str, CircuitBreaker] = {}
        # last-known-good answers for degraded serving, keyed
        # (tenant, lo, hi, beta) → (hist, eps, {pid: n}, store version);
        # recorded only by degraded_ok=True query_many calls (the serving
        # plane), so direct strict callers pay nothing
        self._last_good: dict[tuple, tuple] = {}
        self._last_good_cap = 4096
        self._clock = time.monotonic  # injectable for deadline tests
        self.degraded_served = 0  # Answer(degraded=True) responses handed out
        self.pack_fallbacks = 0  # shared-arena gathers that fell to host pack
        # standing-query planes (serve/subscriptions.py) attach here:
        # every ingest/sweep/eviction tick notifies them which tenants'
        # versions moved.  Runtime state — never persisted.
        self._stale_listeners: list = []
        self.last_scrub: dict | None = None  # scrub() report (core/scrub.py)
        self.last_salvage: dict | None = None  # recover(salvage=True) report
        # hot-standby shipper (core/replication.py) — attached via
        # Replicator.attach(): the async ack path ships through the
        # pool's on_durable hook, the synchronous ingest path in
        # _replication_ship, and health() surfaces its stats.  Runtime
        # wiring — never persisted.
        self._replication = None

    @property
    def host_row_copies(self) -> int:
        """Host-side node-row materializations across this registry's
        arena(s) — the machine-checked zero-copy counter of the shared-
        arena gather path (mirrors ``merge_dispatches``)."""
        if self.arena is not None:
            return self.arena.host_row_copies
        with self._lock:
            stores = list(self._stores.values())
        return sum(s._tree.arena.host_row_copies for s in stores)

    def reset_host_row_copies(self) -> None:
        if self.arena is not None:
            self.arena.host_row_copies = 0
            return
        with self._lock:
            stores = list(self._stores.values())
        for s in stores:
            s._tree.arena.host_row_copies = 0

    # (PoolStateView provides _cv/_pending/_ingest_mutex onto the pool)
    @property
    def _errors(self) -> list:
        """Every failed partition since the last flush: [(tenant, pid,
        exc)]; a ``(None, None, exc)`` entry is a failed retention/budget
        sweep."""
        return self._pool.errors

    @_errors.setter
    def _errors(self, value: list) -> None:
        self._pool.errors = value

    # -------------------------------------------------------------- tenants
    def tenant(self, name: str) -> HistogramStore:
        """Get-or-create the named store (shared registry configuration).

        Names are str()-normalized everywhere (lookup and storage alike),
        so ``reg.tenant(5)`` and ``reg.tenant("5")`` are the same tenant.
        Stores are created synchronous (``async_ingest=False``) — the
        registry's own worker pool is the async plane.
        """
        name = str(name)
        with self._lock:
            store = self._stores.get(name)
            if store is None:
                store = HistogramStore(
                    num_buckets=self.num_buckets,
                    engine=self.engine,
                    T_node=self.T_node,
                    cache_size=self.cache_size,
                    retention=self.retention,
                    collapse=self.collapse,
                    arena=self.arena,
                    device=self.device,
                )
                # key the store lock by tenant name: the witness enforces
                # the sorted-order contract for multi-store sites
                # (_apply_groups_batched, save) via ascending-key checks
                store._lock.key = name
                self._stores[name] = store
            return store

    def __getitem__(self, name: str) -> HistogramStore:
        with self._lock:
            try:
                return self._stores[str(name)]
            except KeyError:
                raise KeyError(f"unknown tenant: {name!r}") from None

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return str(name) in self._stores

    def __len__(self) -> int:
        with self._lock:
            return len(self._stores)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._stores)

    # --------------------------------------------------------- self-healing
    def _breaker(self, name: str) -> CircuitBreaker | None:
        """This tenant's circuit breaker (lazily created; None when the
        registry runs without a ``breaker`` policy)."""
        if self.breaker_policy is None:
            return None
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                b = CircuitBreaker(self.breaker_policy)
                self._breakers[name] = b
            return b

    def _breaker_check(self, name: str) -> None:
        """Reject a submit for a quarantined tenant at the door."""
        b = self._breaker(name)
        if b is not None and not b.allow():
            raise TenantQuarantined(name, b.state)

    def _breaker_ok(self, name: str) -> None:
        b = self._breaker(name)
        if b is not None:
            b.record_success()

    def _breaker_fail(self, name: str) -> None:
        """Count one ingest failure against the tenant — whatever the
        cause (poison data, apply fault): ``threshold`` consecutive ones
        trip the breaker and quarantine the tenant."""
        b = self._breaker(name)
        if b is not None:
            b.record_failure()

    def scrub(self, *, repair: bool = False) -> dict:
        """Run the integrity scrubber over every tenant (core/scrub.py);
        with ``repair=True`` corrupted tenants are routed through
        WAL-replay rebuild.  The report also lands on ``last_scrub``
        (surfaced by :meth:`health`)."""
        return scrub_registry(self, repair=repair)

    def health(self) -> dict:
        """One-call serving-plane health: breaker/quarantine states,
        degraded-answer and backpressure counters, WAL and pool stats,
        and the latest recovery/scrub reports.  ``status`` is
        ``"degraded"`` when any tenant is quarantined, unflushed ingest
        errors are pending, or the last scrub saw corruption."""
        with self._lock:
            breakers = {n: b.snapshot() for n, b in self._breakers.items()}
            last_scrub = self.last_scrub
        quarantined = sorted(
            n for n, b in breakers.items() if b["state"] != "closed"
        )
        pool = self._pool.stats()
        degraded = bool(
            quarantined
            or pool["errors_pending"]
            or (last_scrub is not None and last_scrub["corrupt"])
        )
        # standing-query plane counters (subscription counts, push lag,
        # dedup/overflow accounting) — None when no plane is attached,
        # the single plane's stats dict in the common case
        planes = list(self._stale_listeners)
        if not planes:
            subscriptions = None
        elif len(planes) == 1:
            subscriptions = planes[0].stats()
        else:
            subscriptions = [p.stats() for p in planes]
        # replication stats read outside _lock (the Replicator takes its
        # own rank-2 lock, which must never nest inside registry._lock)
        replication = (
            None if self._replication is None else self._replication.stats()
        )
        return {
            "status": "degraded" if degraded else "ok",
            "tenants": len(self),
            "quarantined": quarantined,
            "breakers": breakers,
            "degraded_served": self.degraded_served,
            "pack_fallbacks": self.pack_fallbacks,
            "subscriptions": subscriptions,
            "pool": pool,
            "backpressure": pool["backpressure"],
            "replication": replication,
            "wal": self.wal_stats(),
            "last_recovery": self.last_recovery,
            "last_scrub": last_scrub,
            "last_salvage": self.last_salvage,
        }

    # ----------------------------------------------------------- Summarizer
    def _wal_log_sync(
        self, tenant: str, parts: dict[int, np.ndarray]
    ) -> list[int]:
        """Append a synchronous-ingest batch (one tenant) to the registry
        WAL with one group-commit fsync; empty without a log."""
        if self._wal is None or not parts:
            return []
        lsns = [
            self._wal.append(tenant, pid, _validated(v))
            for pid, v in parts.items()
        ]
        self._wal.commit(lsns[-1])
        return lsns

    def _replication_ship(self) -> None:
        """Ship-before-ack (core/replication.py): a failed ship fails
        the ingest, so the caller never holds an ack the follower
        directories don't hold bytes for.  Runs *outside* the
        breaker-attributed try (like the async path's ``on_durable``
        hook): a replication transport outage is a cluster condition,
        not tenant poison — it must not quarantine healthy tenants."""
        if self._replication is not None:
            self._replication.ship()

    def wal_stats(self) -> dict | None:
        """WAL depth / fsync-latency / footprint counters (telemetry),
        or ``None`` when the registry runs without a log."""
        return None if self._wal is None else self._wal.stats()

    def ingest(self, tenant: str, partition_id: int, values):
        """Synchronous single-partition ingest into the named tenant.

        With a ``breaker`` policy a quarantined tenant is rejected before
        any work (:class:`TenantQuarantined`); the outcome of the ingest
        is recorded against the tenant's breaker either way.
        """
        name = str(tenant)
        self._breaker_check(name)
        try:
            faults.hit("tenant.apply", tenant=name, parts=1)
            lsns = self._wal_log_sync(name, {int(partition_id): values})
            out = self.tenant(name).ingest(partition_id, values)
        except BaseException:
            self._breaker_fail(name)
            raise
        self._breaker_ok(name)
        self._replication_ship()
        if self._wal is not None:
            self._wal.mark_applied(lsns)
        self._enforce_budget_cached([name])
        self._notify_stale((name,))
        return out

    def ingest_many(self, tenant: str, partitions: dict[int, np.ndarray]) -> None:
        """Grouped one-dispatch bulk ingest into the named tenant (with a
        WAL: the whole batch logged under one group-commit fsync)."""
        name = str(tenant)
        self._breaker_check(name)
        try:
            faults.hit("tenant.apply", tenant=name, parts=len(partitions))
            lsns = self._wal_log_sync(name, dict(partitions))
            self.tenant(name).ingest_many(partitions)
        except BaseException:
            self._breaker_fail(name)
            raise
        self._breaker_ok(name)
        self._replication_ship()
        if self._wal is not None:
            self._wal.mark_applied(lsns)
        self._enforce_budget_cached([name])
        self._notify_stale((name,))

    def ingest_async(self, tenant: str, partition_id: int, values) -> None:
        """Enqueue one partition for the shared background worker pool.

        Validation is synchronous (a bad partition fails the caller, not
        the pool); visibility comes with the worker's next flush of the
        batch — call :meth:`flush` to wait for everything enqueued so far.
        """
        values = _validated(values)
        name = str(tenant)
        self._breaker_check(name)  # quarantined tenants rejected at the door
        self.tenant(name)  # create eagerly: queries can see the tenant
        # stable per-tenant routing keeps each tenant's partitions FIFO —
        # hash() is salted per process but stable within one, which is all
        # that per-tenant FIFO needs
        self._pool.submit((name, int(partition_id), values), route=hash(name))

    def _apply_worker_batch(
        self, batch: list[tuple[str, int, np.ndarray]]
    ) -> None:
        """IngestPool apply callback: group the drained batch by tenant and
        apply each group with the store's grouped one-dispatch summarizer.

        Per-tenant groups apply independently: a poison partition narrows
        the pool's retry to its own group's items (PartialBatchFailure),
        so tenants whose groups already applied are not re-summarized —
        and their store versions aren't churned.  A single-group batch
        lets the real exception propagate, so the per-item retry records
        the underlying error, not a wrapper.
        """
        with spans.span("store.ingest"):
            groups: dict[str, dict[int, np.ndarray]] = {}
            for name, pid, values in batch:
                groups.setdefault(name, {})[pid] = values
            if len(groups) == 1:
                ((name, parts),) = groups.items()
                store = self.tenant(name)
                faults.hit("tenant.apply", tenant=name, parts=len(parts))
                store._apply(store._summarize_batch(parts))
                self._breaker_ok(name)
                return
            if self.arena is not None:
                self._apply_groups_batched(batch, groups)
                return
            suspects: list[tuple[str, int, np.ndarray]] = []
            for name, parts in groups.items():
                store = self.tenant(name)
                try:
                    faults.hit("tenant.apply", tenant=name, parts=len(parts))
                    store._apply(store._summarize_batch(parts))
                    self._breaker_ok(name)
                except BaseException:
                    suspects += [
                        item for item in batch if item[0] == name
                    ]
            if suspects:
                raise PartialBatchFailure(suspects)

    def _apply_groups_batched(
        self,
        batch: list[tuple[str, int, np.ndarray]],
        groups: dict[str, dict[int, np.ndarray]],
    ) -> None:
        """Shared-arena apply: one cross-tenant pull-up per drained batch.

        Summarization runs per tenant first (failures narrow the pool's
        retry to that tenant's items, like the sequential path), then every
        successful group's leaves are written and ALL touched trees are
        pulled up together — one merge dispatch per level for the whole
        batch instead of per tenant (``pull_up_trees``).  The touched
        stores' locks are held for the whole write+pull-up (acquired in
        sorted-name order; per-tenant FIFO routing keeps two workers'
        tenant sets disjoint, and no other path acquires two store locks),
        so queries still see each tenant only in whole-batch states.
        """
        summarized: dict[str, tuple[HistogramStore, dict]] = {}
        suspects: list[tuple[str, int, np.ndarray]] = []
        for name, parts in groups.items():
            store = self.tenant(name)
            try:
                faults.hit("tenant.apply", tenant=name, parts=len(parts))
                summarized[name] = (store, store._summarize_batch(parts))
            except BaseException:
                suspects += [item for item in batch if item[0] == name]
        names = sorted(summarized)
        with spans.span("store.tree_update"), ExitStack() as stack:
            for name in names:
                stack.enter_context(summarized[name][0]._lock)
            applied: list[HistogramStore] = []
            try:
                work = []
                for name in names:
                    store, summs = summarized[name]
                    tree, dirty = store._apply_deferred(summs)
                    applied.append(store)
                    if dirty:
                        work.append((tree, dirty))
                pull_up_trees(work)
                for name in names:
                    summarized[name][0]._tree._invalidate()
            except BaseException:
                # a mid-apply failure must not release the locks with any
                # tenant's leaves written but ancestors stale — a query
                # would verify and CACHE that state.  Rebuild each touched
                # tree from its (already updated) summaries before
                # re-raising; the pool's per-item retry then re-applies.
                for store in applied:
                    try:
                        store.rebuild_tree()
                    except BaseException:
                        pass  # best effort; the original error surfaces
                raise
        # breaker acks AFTER the store locks are released: _breaker_ok
        # takes registry._lock (rank 10), and holding store locks (rank
        # 20) at that point inverts the hierarchy against save()/
        # query_many()'s registry→store nesting — a latent ABBA deadlock
        # surfaced by the static lock graph (scripts/analyze.py)
        for name in names:
            self._breaker_ok(name)
        if suspects:
            raise PartialBatchFailure(suspects)

    def _wrap_async_error(self, item, exc: BaseException):
        # pool error record: (tenant, pid, exception); a failed retention/
        # budget sweep (item None) records as (None, None, exception).
        # This is also where an async-ingested partition's terminal
        # failure (after the pool's per-item retry budget) counts against
        # its tenant's circuit breaker.
        if item is None:
            return (None, None, exc)
        self._breaker_fail(item[0])
        return (item[0], item[1], exc)

    def _sweep_after_batch(
        self, batch: list[tuple[str, int, np.ndarray]]
    ) -> None:
        """Retention slot of the pool worker: per-tenant sweeps for the
        tenants this batch touched, then the registry-wide budget (the
        cached-total check — only touched tenants are recounted) — runs
        between flushes, before the pending count drops."""
        touched = {item[0] for item in batch}
        if self.retention is not None:
            for name in touched:
                with self._lock:
                    store = self._stores.get(name)
                if store is not None:
                    store.sweep_retention()
        self._enforce_budget_cached(touched)
        self._notify_stale(touched)

    def _notify_stale(self, names) -> None:
        """Tick the attached subscription planes: the named tenants'
        versions may have moved.  Called with NO locks held (plane
        bookkeeping ranks below ``registry._lock`` and may call back into
        the registry)."""
        for plane in list(self._stale_listeners):
            plane.mark_stale(names)

    def flush(self) -> None:
        """Block until every enqueued partition is visible (and swept);
        surface errors.

        Re-raises (wrapped) every per-partition failure the pool hit since
        the last flush; valid partitions co-batched with a poison one are
        retried and applied individually, so the pool never wedges.
        """
        errs = self._pool.drain()
        if errs:
            detail = "; ".join(
                f"tenant {t!r} partition {pid}: {e!r}"
                if t is not None
                else f"retention sweep: {e!r}"
                for t, pid, e in errs
            )
            raise RuntimeError(
                f"async ingest failed for {len(errs)} partition(s): {detail}"
            ) from errs[0][2]

    def close(self) -> None:
        """Drain the pool, stop its workers, surface pending errors.
        Attached subscription planes are closed first (their evaluation
        workers drain, subscribers see ``closed``)."""
        for plane in list(self._stale_listeners):
            plane.close()
        self._pool.close()
        self.flush()

    # ------------------------------------------------------------ retention
    def node_floats(self) -> dict[str, int]:
        """Per-tenant tree node-float footprints (version-cached)."""
        with self._lock:
            names = list(self._stores)
        return {name: self._store_floats(name) for name in names}

    def _store_floats(self, name: str) -> int:
        # lock order: store lock and registry lock are taken sequentially,
        # never nested (save() nests registry→store, so nesting store→
        # registry here would be a lock-order inversion)
        with self._lock:
            store = self._stores[name]
            hit = self._floats_cache.get(name)
        with store._lock:
            v = store._tree.version
            if hit is not None and hit[0] == v:
                return hit[1]
            floats = store._tree.node_floats()
        with self._lock:
            self._floats_cache[name] = (v, floats)
        return floats

    def _enforce_budget_cached(self, touched) -> None:
        """Budget check without the O(#tenants) lock scan — shared by
        sync ingest and the pool worker's between-flush sweep.

        Only the mutated tenants' footprints are recounted (their
        versions bumped anyway); untouched tenants answer from the
        version cache.  The full :meth:`enforce_budget` scan runs only
        when the cached total crosses the budget or some tenant has
        never been counted — so a hot ingest loop under budget costs one
        store recount per batch, not three lock round-trips per tenant.
        """
        if self.budget is None:
            return
        for name in touched:
            with self._lock:
                present = str(name) in self._stores
            if present:
                self._store_floats(str(name))
        with self._lock:
            cached_total = sum(f for _, f in self._floats_cache.values())
            complete = len(self._floats_cache) == len(self._stores)
        if not complete or cached_total > self.budget:
            self.enforce_budget()

    def enforce_budget(self) -> dict[str, list[int]]:
        """Evict until the summed node-float footprint fits ``budget``.

        Fairness rule: quota = budget / #tenants; while over budget, the
        **largest-over-quota tenant** gives up its oldest partitions
        first, down to its quota (or just far enough to fit the budget,
        whichever is less eviction) — an under-quota tenant is never
        touched, and no tenant loses its newest partition.  Returns
        ``{tenant: [evicted ids]}``.  No-op without a budget.
        """
        if self.budget is None:
            return {}
        evicted: dict[str, list[int]] = {}
        while True:
            sizes = self.node_floats()
            total = sum(sizes.values())
            if not sizes or total <= self.budget:
                break
            quota = self.budget / len(sizes)
            progressed = False
            # largest-over-quota tenant first
            for name in sorted(sizes, key=lambda n: -sizes[n]):
                if sizes[name] <= quota:
                    break  # nobody else is over quota either
                with self._lock:
                    store = self._stores[name]
                # shrink to quota, or just under the global overflow —
                # delegate the "how many oldest partitions" estimate to
                # the MemoryBudget policy and let the outer loop converge
                target = max(int(quota), sizes[name] - (total - self.budget))
                victims = []
                with store._lock:
                    stats = store._retention_stats()
                    victims = store.evict(
                        MemoryBudget(max(1, target)).victims(stats)
                    )
                if victims:
                    evicted.setdefault(name, []).extend(victims)
                    progressed = True
                    break
            if not progressed:
                break  # every over-quota tenant is down to one partition
        if evicted:
            # eviction moves versions too — standing queries over an
            # evicted tenant's windows are stale exactly like post-ingest
            self._notify_stale(evicted)
        return evicted

    # --------------------------------------------------------------- Merger
    def query(
        self, tenant: str, lo: int, hi: int, beta: int, **kwargs
    ) -> tuple[Histogram, float]:
        """Single-tenant query — delegates to the named store."""
        return self[tenant].query(lo, hi, beta, **kwargs)

    def query_many(
        self,
        queries: Sequence[tuple[str, int, int]],
        beta: int,
        *,
        strict: bool = True,
        degraded_ok: bool = False,
        deadline: float | None = None,
    ) -> list[tuple[Histogram | None, float]]:
        """Answer ``[(tenant, lo, hi), ...]`` with ≤ one merge dispatch.

        Each query's canonical node set is collected under its own store's
        lock (per-tenant snapshot consistency), per-tenant LRU caches are
        consulted first, and all misses — deduplicated, across tenants —
        are packed into one block and merged by a single ``merge_stacks``
        call on the registry's device.  Answers are returned in query order
        (stable indexing) and populated back into each tenant's cache.

        ``strict=False`` applies the store-level summary-loss contract per
        query: an unknown tenant or an interval with zero present summaries
        yields the placeholder ``(None, float("inf"))`` instead of killing
        the batch; with ``strict=True`` both raise ``KeyError``.

        ``degraded_ok=True`` is the self-healing serving contract: when
        answering *fails* — the merge dispatch (or a query's node
        selection) raises, or ``deadline`` (absolute, by the registry
        clock) has passed before the dispatch — the affected queries are
        served their last known-good answer as an
        :class:`~repro_torch.core.resilience.Answer` with ``degraded=True`` and
        an **honestly widened** ``eps_total`` (the cached bound plus all
        mass added to or removed from the interval since it was cached),
        instead of killing the batch.  Strict-contract ``KeyError``\\ s
        still raise — a missing partition is a caller error, not a fault.
        Fresh answers stay plain ``(hist, eps)`` tuples (``degraded``
        reads False), and only ``degraded_ok=True`` calls record/maintain
        the last-known-good cache.
        """
        results: list[tuple[Histogram | None, float] | None] = [None] * len(
            queries
        )
        # mkey (store id + cache key) → (miss row, result slots)
        miss_map: dict[tuple, tuple[int, list[int]]] = {}
        miss_sels: list[list] = []
        miss_meta: list[tuple[HistogramStore, tuple, tuple, dict | None]] = []
        for qi, (name, lo, hi) in enumerate(queries):
            if not strict and name not in self:
                results[qi] = (None, float("inf"))
                continue
            gkey = (str(name), int(lo), int(hi), int(beta))
            try:
                store = self[name]
                tree = store._tree
                with store._lock:
                    ids = store._present_ids(lo, hi)
                    if strict and len(ids) != hi - lo + 1:
                        missing = sorted(set(range(lo, hi + 1)) - set(ids))
                        raise KeyError(
                            f"tenant {name!r}: missing partition summaries: "
                            f"{missing}"
                        )
                    keys = store._sync_tree(ids, lo, hi)
                    if not ids:
                        if strict:
                            raise KeyError(
                                f"tenant {name!r}: no partition summaries in "
                                f"requested interval"
                            )
                        results[qi] = (None, float("inf"))
                        continue
                    key = (int(lo), int(hi), int(beta), tree.version)
                    mkey = (id(store), key)
                    prior = miss_map.get(mkey)
                    if prior is not None:  # duplicate within this batch
                        prior[1].append(qi)
                        continue
                    hit = tree._cache_get(key)
                    if hit is not None:
                        results[qi] = hit
                        continue
                    tree.cache_misses += 1
                    sel = [tree.nodes[k] for k in keys]
                    members = (
                        {pid: store.summaries[pid].n for pid in ids}
                        if degraded_ok
                        else None
                    )
                    miss_map[mkey] = (len(miss_sels), [qi])
                    miss_sels.append(sel)
                    miss_meta.append((store, key, gkey, members))
            except KeyError:
                raise  # strict-contract violations are not faults
            except BaseException:
                if not degraded_ok:
                    raise
                results[qi] = self._degraded_answer(gkey)
        if miss_sels:
            try:
                if deadline is not None and self._clock() >= deadline:
                    raise TimeoutError(
                        "query deadline passed before the merge dispatch"
                    )
                faults.hit("tenant.merge", misses=len(miss_sels))
                # ONE cross-tenant merge dispatch for the whole batch.
                # Packing outside the store locks is safe: arena rows are
                # write-once and the node handles held in miss_sels pin
                # them against concurrent eviction + reuse (core/arena.py
                # slot lifecycle).
                packed = None
                if self.arena is not None:
                    # shared arena: assemble the whole merge stack with a
                    # single device gather — zero host-side row copies
                    packed = pack_device_rows(miss_sels)
                    if packed is None:
                        with self._lock:
                            self.pack_fallbacks += 1
                if packed is None:
                    # per-tenant arenas (or a mixed-plane selection, e.g.
                    # geometric T_node): host pack, one stacked copy per
                    # plane, padded to the plane width so the block is
                    # bit-identical to the gather path's
                    T_pad = max(nd.width for sel in miss_sels for nd in sel)
                    packed = pack_node_rows(
                        miss_sels, T_pad=T_pad, pad_row_copy=True
                    )
                bounds, sizes = packed
                with self._lock:  # counters read by concurrent servers
                    self.merge_dispatches += 1
                    self.merge_shapes.add(tuple(bounds.shape) + (int(beta),))
                bo, so = merge_stacks(bounds, sizes, int(beta), device=self.device)
                # one device→host transfer each; per-row unpacking is free
                # views
                bo, so = bo.cpu().numpy(), so.cpu().numpy()
            except BaseException:
                if not degraded_ok:
                    raise
                # the dispatch failed (or the deadline passed): every miss
                # gets its last known-good answer, honestly widened
                for row, slots in miss_map.values():
                    _store, _key, gkey, members = miss_meta[row]
                    ans = self._degraded_answer(gkey, members)
                    for qi in slots:
                        results[qi] = ans
                return results
            for row, slots in miss_map.values():
                store, key, gkey, members = miss_meta[row]
                out = (
                    Histogram(bo[row], so[row]),
                    selection_eps(miss_sels[row]),
                )
                with store._lock:
                    store._tree._cache_put(key, out)
                if members is not None:
                    self._remember_good(gkey, out, members, key[3])
                for qi in slots:
                    results[qi] = out
        return results

    def _remember_good(
        self, gkey: tuple, out: tuple, members: dict, version: int
    ) -> None:
        """Record a fresh answer as ``gkey``'s degraded-serving fallback
        (bounded FIFO — oldest entries age out past the cap)."""
        with self._lock:
            self._last_good.pop(gkey, None)
            self._last_good[gkey] = (out[0], float(out[1]), members, version)
            while len(self._last_good) > self._last_good_cap:
                self._last_good.pop(next(iter(self._last_good)))

    def _degraded_answer(self, gkey: tuple, now: dict | None = None):
        """The last known-good answer for ``gkey`` as a degraded
        :class:`Answer`, its ``eps_total`` widened by every unit of mass
        added to or removed from the interval since it was cached (the
        honest bound on what staleness can have changed).  ``now`` is the
        current ``{pid: n}`` membership if the caller captured one; with
        no cached answer — or no way to read the current membership — the
        placeholder ``(None, inf)`` / an ``inf``-widened answer is served
        instead of guessing.
        """
        name, lo, hi, _beta = gkey
        if now is None:
            try:
                with self._lock:
                    store = self._stores.get(name)
                now = (
                    {}
                    if store is None
                    else {
                        pid: s.n
                        for pid, s in list(store.summaries.items())
                        if lo <= pid <= hi
                    }
                )
            except Exception:  # store too broken to read: widen to inf
                now = None
        with self._lock:
            self.degraded_served += 1
            cached = self._last_good.get(gkey)
        if cached is None:
            return Answer.make(None, float("inf"), degraded=True)
        hist, eps, members, version = cached
        if now is None:
            return Answer.make(
                hist, float("inf"), degraded=True, stale_version=version
            )
        drift = 0.0
        for pid, n in now.items():
            drift += abs(n - members.get(pid, 0))
        for pid, n in members.items():
            if pid not in now:
                drift += n
        return Answer.make(
            hist, eps + drift, degraded=True, stale_version=version
        )

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Atomic one-npz write of every tenant (summaries + tree nodes).

        With a shared arena the node pools are exported **once for the
        whole registry** — compacted to the live rows of all tenants
        (``arena_ab_{width}``/``arena_as_{width}``), with each tenant's
        node records pointing into that one slot map — instead of one
        array dict per tenant.

        With a WAL this is the registry checkpoint: the log's
        ``stable_lsn`` is captured *before* any store state is read (so
        everything ≤ it is covered by this snapshot), persisted as
        ``meta["wal_stable_lsn"]``, and covered segments are deleted only
        after the atomic rename succeeds.
        """
        stable = None if self._wal is None else self._wal.stable_lsn
        with self._lock:
            names = sorted(self._stores)
            payload: dict[str, np.ndarray] = {}
            stores_meta: dict[str, dict] = {}
            with ExitStack() as stack:
                stores = [self._stores[n] for n in names]
                slot_map = None
                if self.arena is not None:
                    # hold every store lock so the export and each tree's
                    # node records describe one consistent snapshot
                    for store in stores:
                        stack.enter_context(store._lock)
                    arrays, slot_map = self.arena.export(
                        (nd.width, nd.row)
                        for store in stores
                        for nd in store._tree.nodes.values()
                    )
                    payload.update(
                        {f"arena_{k}": v for k, v in arrays.items()}
                    )
                for i, (name, store) in enumerate(zip(names, stores)):
                    if self.arena is None:
                        with store._lock:
                            meta_i, payload_i = store._state(prefix=f"t{i}_")
                    else:  # locks already held
                        meta_i, payload_i = store._state(
                            prefix=f"t{i}_", tree_slot_map=slot_map
                        )
                    stores_meta[name] = meta_i
                    payload.update(payload_i)
            meta = {
                "schema": _SCHEMA,
                "num_buckets": self.num_buckets,
                "engine": self.engine,
                "T_node": self.T_node,
                "cache_size": self.cache_size,
                "retention": (
                    None if self.retention is None else self.retention.spec()
                ),
                "budget": self.budget,
                "shared_arena": self.arena is not None,
                "collapse": self.collapse,
                "wal_stable_lsn": stable,
                "tenants": names,
                "stores": stores_meta,
            }
        atomic_savez(path, meta, payload)
        if self._wal is not None:
            self._wal.truncate(stable)

    @classmethod
    def _from_state(cls, meta: dict, data, device=None) -> "TenantRegistry":
        """A registry holding every tenant of a saved registry's ``meta``
        (the npz's ``"meta"`` json) and array container ``data``."""
        if meta.get("schema") != _SCHEMA:
            raise ValueError(
                f"not a tenant registry file: schema={meta.get('schema')!r}"
            )
        T_node = meta.get("T_node")
        reg = cls(
            num_buckets=int(meta["num_buckets"]),
            engine=str(meta.get("engine", "tree")),
            T_node=T_node if T_node in (None, "geometric") else int(T_node),
            cache_size=int(meta.get("cache_size", 128)),
            retention=policy_from_spec(meta.get("retention")),
            budget=meta.get("budget"),
            shared_arena=bool(meta.get("shared_arena", False)),
            collapse=str(meta.get("collapse", "canonical")),
            device=device,
        )
        shared_pools = (
            _PrefixedArrays(data, "arena_") if reg.arena is not None else None
        )
        for i, name in enumerate(meta["tenants"]):
            store = reg.tenant(name)
            store._restore(
                meta["stores"][name],
                data,
                prefix=f"t{i}_",
                tree_arrays=shared_pools,
            )
        return reg

    @classmethod
    def load(
        cls, path: str, wal_dir: str | None = None, device=None
    ) -> "TenantRegistry":
        """Restore every tenant from the one-npz container (written by
        this package or the reference) onto ``device``; with ``wal_dir``,
        also replay the log suffix the snapshot doesn't cover (see
        :meth:`recover` for the missing-snapshot case)."""
        # context-managed NpzFile (same fd-leak rule as HistogramStore
        # .load): every tenant's arrays are materialized inside this block
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            reg = cls._from_state(meta, data, device)
        if wal_dir is not None:
            reg._attach_wal(wal_dir, meta.get("wal_stable_lsn"))
        return reg

    @classmethod
    def recover(
        cls,
        path: str,
        wal_dir: str,
        *,
        salvage: bool = False,
        **registry_kwargs,
    ) -> "TenantRegistry":
        """Crash-consistent startup: snapshot + WAL → the acked state.

        If ``path`` exists it is loaded and the WAL's uncovered suffix
        replayed on top; if the crash happened before the first save, the
        registry is rebuilt from the WAL alone using ``registry_kwargs``
        as its configuration (its ``device`` also places a loaded
        snapshot).  Every acked ingest — including partitions
        that were still sitting in the in-memory queue when the process
        died — is present afterwards, and the registry keeps logging to
        ``wal_dir``.

        ``salvage=True`` adds the bit-rot leg of the self-healing plane:
        the snapshot's payload checksums are verified first
        (:func:`~repro_torch.core.scrub.verify_snapshot`), and a corrupt or
        unloadable snapshot is moved aside to ``path + ".corrupt"`` and
        the registry rebuilt from the WAL alone — wrong answers are never
        served from rotted bytes.  The verification report lands on
        ``last_salvage`` (and :meth:`health`).
        """
        if os.path.exists(path):
            report = None
            if salvage:
                report = verify_snapshot(path)
            if report is None or report["ok"]:
                try:
                    reg = cls.load(
                        path, wal_dir=wal_dir, device=registry_kwargs.get("device")
                    )
                    reg.last_salvage = report
                    return reg
                except Exception as e:
                    if not salvage:
                        raise
                    report = {"ok": False, "error": repr(e)}
            # corrupt snapshot: quarantine the file, rebuild from the WAL
            os.replace(path, path + ".corrupt")
            reg = cls(**registry_kwargs)
            reg._attach_wal(wal_dir, None)
            reg.last_salvage = report
            return reg
        reg = cls(**registry_kwargs)
        reg._attach_wal(wal_dir, None)
        return reg

    def _attach_wal(self, wal_dir: str, covered_lsn: int | None) -> None:
        """Open (or adopt) the log at ``wal_dir``, replay its uncovered
        suffix into the tenants it routes to, and log future submits."""
        self.wal_dir = str(wal_dir)
        self._wal = WriteAheadLog(self.wal_dir)
        self._wal.ensure_position(covered_lsn)
        self._pool.wal = self._wal
        self._pool.wal_record = lambda item: (item[0], item[1], item[2])
        self._replay_wal(-1 if covered_lsn is None else int(covered_lsn))

    def _replay_wal(self, covered_lsn: int) -> int:
        """Idempotent replay of the WAL suffix above ``covered_lsn``.

        Records are grouped by tenant route (creating tenants as needed —
        ``ingest_async`` created them eagerly pre-crash too) and each
        group re-ingests through the store's grouped summarizer after the
        pid-dedup/watermark reconciliation documented in core/workers.py.
        A record without a tenant route (a standalone store's WAL) is a
        config error and raises.  Returns the number of partitions
        replayed; per-run stats land on ``self.last_recovery``.
        """
        records = self._wal.recovered_records()
        per_tenant: dict[str, dict[int, np.ndarray]] = {}
        for rec in records:
            if rec.lsn <= covered_lsn:
                continue
            if rec.tenant is None:
                raise ValueError(
                    "WAL record without a tenant route — this log was "
                    "written by a standalone HistogramStore, not a registry"
                )
            # duplicate pids within the suffix: last append wins
            per_tenant.setdefault(str(rec.tenant), {})[rec.pid] = rec.values
        replayed = 0
        for name, parts in sorted(per_tenant.items()):
            store = self.tenant(name)
            fresh = {
                pid: v
                for pid, v in parts.items()
                if pid not in store.summaries
                and (store.watermark is None or pid > store.watermark)
            }
            if fresh:
                store._apply(store._summarize_batch(fresh))
                store._maybe_sweep()
                replayed += len(fresh)
        if per_tenant:
            self._enforce_budget_cached(per_tenant.keys())
        self._wal.mark_applied(rec.lsn for rec in records)
        self.last_recovery = {
            "records_scanned": len(records),
            "replayed": replayed,
            "skipped_covered": len(records) - replayed,
            "torn_records_dropped": self._wal.torn_records_dropped,
        }
        return replayed

    # ------------------------------------------------------------- utility
    def cache_stats(self) -> dict[str, int]:
        """Aggregated per-tenant cache counters, the registry's dispatch
        and host-copy counts, then every span total and counter of
        :mod:`~repro_torch.core.spans`: those are process-wide, as
        ``kernels._lib.LAUNCHES`` is, and cover every store and registry
        in the process."""
        with self._lock:
            stores = list(self._stores.values())
        hits = sum(s._tree.cache_hits for s in stores)
        misses = sum(s._tree.cache_misses for s in stores)
        return {
            "hits": hits,
            "misses": misses,
            "merge_dispatches": self.merge_dispatches,
            "merge_shapes": len(self.merge_shapes),
            "host_row_copies": self.host_row_copies,
            **spans.snapshot(),
        }
