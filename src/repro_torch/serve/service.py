"""Crash-recoverable multi-tenant histogram server (the serving plane).

PyTorch port of ``repro.serve.engine.HistogramService``, in a module of
its own: the port's ``Engine`` (``serve/engine.py``) does not need it.  ``registry_kwargs``
(``device`` among them: ``None`` → the card, raising without one,
``"cpu"`` → the kernels' plain versions) reach the recovered registry and
a replica's :class:`~repro_torch.core.replication.Follower`, so ingest,
WAL replay, pull-ups and every query run on the card by default.

:class:`HistogramService` is the always-on metrics sidecar of a serving
engine: a crash-recoverable multi-tenant histogram server (the paper's
query plane as a service) whose startup replays the write-ahead log
against the last snapshot, so acked latency/throughput windows survive a
process kill (core/workers.py, "Write-ahead log" design note).
"""
from __future__ import annotations

import os

from repro_torch.core.replication import DirTransport, Follower, Replicator
from repro_torch.core.resilience import NotPrimary
from repro_torch.core.tenant import TenantRegistry
from repro_torch.serve.subscriptions import Subscription, SubscriptionPlane

__all__ = ["HistogramService"]


class HistogramService:
    """Crash-recoverable histogram server wrapping one data directory.

    The directory holds the two durability artifacts — ``registry.npz``
    (the last atomic snapshot) and ``wal/`` (the write-ahead log) — and
    startup is *recovery-aware*: ``TenantRegistry.recover`` loads the
    snapshot if present, replays the WAL suffix above its
    ``wal_stable_lsn`` (pid-dedup + watermark reconciliation), and routes
    all future ingest through the log.  A serving deployment therefore
    never loses an acked metric window: kill -9 between ``record`` and
    ``checkpoint`` replays on the next start, and ``checkpoint()``
    truncates the log down to the uncovered suffix.

    >>> svc = HistogramService(data_dir, num_buckets=128)
    >>> svc.recovery            # {'records_scanned': ..., 'replayed': ...}
    >>> svc.record("latency_ms", window_id, samples)
    >>> svc.quantile("latency_ms", lo, hi, 0.95)
    >>> svc.checkpoint()        # atomic snapshot + WAL truncation

    **Roles (core/replication.py).**  ``role="primary"`` (default) with
    ``replicate_to=[dir_or_transport, ...]`` ships every WAL byte to
    those followers *before the ingest ack* — zero acked loss across a
    primary kill.  ``role="replica"`` serves reads from the shipped
    directory instead: ``record``/``record_async`` raise
    :class:`~repro_torch.core.resilience.NotPrimary`, ``sync()`` tails new
    shipped bytes, ``query_many`` answers with ``eps`` honestly widened
    by the replication-lag drift bound and ``degraded=True`` past the
    ``staleness_slo``, and ``promote()`` is the failover: fence the old
    primary, drain, adopt the shipped log, flip the role to primary.
    """

    def __init__(
        self,
        data_dir: str,
        *,
        salvage: bool = True,
        role: str = "primary",
        replicate_to=(),
        staleness_slo: float | None = None,
        **registry_kwargs,
    ):
        if role not in ("primary", "replica"):
            raise ValueError(f"role must be primary|replica, got {role!r}")
        self.data_dir = str(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.snapshot_path = os.path.join(self.data_dir, "registry.npz")
        self.wal_dir = os.path.join(self.data_dir, "wal")
        self.role = role
        self.staleness_slo = staleness_slo
        self.replicator: Replicator | None = None
        self.follower: Follower | None = None
        if role == "replica":
            # the wal/ subdirectory is the *shipped* directory: startup
            # "recovery" is simply one tail pass over whatever the
            # primary has shipped so far
            self.follower = Follower(
                self.wal_dir,
                staleness_slo=staleness_slo,
                **registry_kwargs,
            )
            self.registry = self.follower.registry
            self.follower.tail()
            self.recovery = None
            self.salvage = None
            self._plane = None
            return
        # salvage=True (the service default): a snapshot whose payload
        # checksums fail is moved aside and the state rebuilt from the
        # WAL alone — a serving sidecar must start, not crash-loop on a
        # rotted file (core/scrub.py)
        self.registry = TenantRegistry.recover(
            self.snapshot_path, self.wal_dir, salvage=salvage,
            **registry_kwargs
        )
        #: replay stats from this startup (records scanned/replayed,
        #: torn records dropped) — surface these in the serving logs
        self.recovery = self.registry.last_recovery
        #: snapshot-verification report when salvage rebuilt from the WAL
        self.salvage = self.registry.last_salvage
        # standing-query plane, created on first subscribe()
        self._plane: SubscriptionPlane | None = None
        if replicate_to:
            # a string/PathLike names a standby *data_dir*: ship into its
            # wal/ subdirectory so the standby has the exact layout a
            # replica-role (and later promoted-primary) service expects
            transports = [
                DirTransport(os.path.join(str(t), "wal"))
                if isinstance(t, (str, os.PathLike)) else t
                for t in replicate_to
            ]
            self.replicator = Replicator(
                self.registry._wal, transports
            ).attach(self.registry)
            # a checkpoint may have truncated snapshot-covered history
            # out of the WAL: bootstrap-ship the snapshot so a fresh
            # standby is not silently missing that prefix (raises,
            # rather than under-replicating, when that history cannot
            # be shipped)
            self.replicator.bootstrap(self.snapshot_path)
            # followers start from the full shipped history: push
            # everything the log already holds before the first ack
            self.replicator.ship()

    # ---- ingest plane ----------------------------------------------------
    def record(self, metric: str, window_id: int, values) -> None:
        """Durably ingest one window of raw samples (fsynced before
        return; see the WAL design note in core/workers.py).  With
        replication attached the record is shipped to every follower
        before this returns."""
        if self.role != "primary":
            raise NotPrimary(f"record() on a {self.role}-role service")
        self.registry.ingest(metric, window_id, values)

    def record_async(self, metric: str, window_id: int, values) -> None:
        """Durable enqueue: the WAL append+fsync (and replication ship)
        happens before this returns, summarization on the worker pool."""
        if self.role != "primary":
            raise NotPrimary(f"record_async() on a {self.role}-role service")
        self.registry.ingest_async(metric, window_id, values)

    def flush(self) -> None:
        self.registry.flush()

    # ---- query plane -----------------------------------------------------
    def quantile(self, metric: str, lo: int, hi: int, q, beta=None):
        return self.registry[metric].quantile_query(lo, hi, q, beta)

    def query_many(
        self,
        panels,
        beta: int = 64,
        strict: bool = False,
        deadline: float | None = None,
    ):
        """Dashboard panel batch.  The service plane defaults to
        ``degraded_ok=True``: a failed merge dispatch (or a missed
        ``deadline``) serves last-known-good answers flagged
        ``degraded=True`` with honestly widened eps instead of a 500 —
        check ``ans.degraded`` (plain fresh answers read False).

        On a replica the batch is served from the follower's registry
        with ``eps`` widened by the lag-drift bound and ``lag_seconds``
        attached; ``degraded=True`` marks any answer that cannot be
        proven to bit-match the primary's acked state."""
        if self.follower is not None and self.role == "replica":
            return self.follower.query_many(
                panels, beta, strict=strict, deadline=deadline
            )
        return self.registry.query_many(
            panels, beta, strict=strict, degraded_ok=True, deadline=deadline
        )

    def sync(self) -> int:
        """Replica: apply newly shipped WAL bytes (one tail pass);
        returns records applied.  No-op (0) on a primary."""
        if self.follower is None or self.role != "replica":
            return 0
        return self.follower.tail()

    def metrics(self) -> list[str]:
        return self.registry.names()

    # ---- standing queries (push plane) -----------------------------------
    @property
    def subscriptions(self) -> SubscriptionPlane:
        """The service's standing-query plane (created on first use);
        its ``flush()`` is the push barrier, its ``stats()`` also rides
        ``health()['subscriptions']``."""
        if self._plane is None:
            self._plane = SubscriptionPlane(self.registry)
        return self._plane

    def subscribe(
        self,
        metric: str,
        lo: int,
        hi: int,
        beta: int = 64,
        *,
        policy: str = "coalesce",
        queue_cap: int = 8,
    ) -> Subscription:
        """Register a standing dashboard query: pushed ``Update``s arrive
        whenever windows ``lo..hi`` of the metric go stale — same answer
        (hist and composed eps) the pull path reports, deduplicated and
        batched into one merge dispatch per ingest tick across ALL
        subscriptions (serve/subscriptions.py)."""
        return self.subscriptions.subscribe(
            metric, lo, hi, beta, policy=policy, queue_cap=queue_cap
        )

    def unsubscribe(self, sub: Subscription) -> None:
        self.subscriptions.unsubscribe(sub)

    # ---- failover plane --------------------------------------------------
    def promote(self, *, fence=None, epoch: int | None = None,
                receivers=()) -> None:
        """Replica → primary failover (core/replication.py): fence the
        deposed primary (``fence`` = its ``Replicator.fence`` /
        ``WriteAheadLog.fence``, best-effort — a dead primary is fine),
        drain the shipped suffix, adopt the shipped log as this
        service's WAL, re-attach the subscription plane, flip the role.
        After this returns, ``record()`` works and ``query_many`` serves
        un-widened primary answers."""
        if self.follower is None or self.role != "replica":
            raise NotPrimary("promote() requires a replica-role service")
        planes = [self._plane] if self._plane is not None else []
        self.follower.promote(
            fence=fence, epoch=epoch, planes=planes, receivers=receivers
        )
        self.role = "primary"
        if any(self.follower._boot_mass.values()):
            # this replica was snapshot-bootstrapped: the adopted WAL
            # alone cannot rebuild the snapshot-covered prefix, so
            # persist a checkpoint now — a restart of the promoted
            # service must recover the full state, not just the suffix
            self.checkpoint()

    # ---- health plane ----------------------------------------------------
    def health(self) -> dict:
        """Serving-plane health aggregate (breakers, quarantine, WAL,
        degraded counters, last recovery/scrub, replication lag/epoch/
        role) — the /healthz payload."""
        out = self.registry.health()
        out["role"] = self.role
        if self.follower is not None:
            out["replication"] = self.follower.stats()
        return out

    def scrub(self, *, repair: bool = False) -> dict:
        """On-demand integrity scrub of every tenant (core/scrub.py);
        ``repair=True`` routes corrupted tenants through WAL-replay
        rebuild."""
        return self.registry.scrub(repair=repair)

    # ---- durability plane ------------------------------------------------
    def checkpoint(self) -> str:
        """Atomic snapshot (tempfile + fsync + rename + dir fsync) then
        WAL truncation of the covered prefix.  Returns the path."""
        self.registry.flush()
        self.registry.save(self.snapshot_path)
        return self.snapshot_path

    def wal_stats(self) -> dict | None:
        return self.registry.wal_stats()

    def close(self) -> None:
        self.registry.close()
