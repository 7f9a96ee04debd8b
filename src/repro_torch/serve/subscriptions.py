"""Standing-query subscription plane: push-based dashboard fan-out.

PyTorch port of ``repro.serve.subscriptions`` (same names, lock ranks and
failpoint sites).  The evaluation worker is a thread of its own, so on the
card the plane's one merge per pass is launched from that thread; the
answers it pushes are host arrays (``TenantRegistry.query_many`` copies
them off the card), so a consumer never reads a tensor still in flight.

The pull model re-asks the same dashboard windows forever: every refresh
is a ``query_many`` through the per-tenant LRU, and every ingest tick
invalidates them all.  This module inverts it.  Clients register a
standing query ``(tenant, lo, hi, beta)`` with :class:`SubscriptionPlane`
and receive pushed :class:`Update`\\ s only when their answer actually
went stale — staleness detected by the machinery that already exists:
``HistogramStore.version`` (the ``_VersionedDict`` mutation token behind
the version-keyed caches in ``core/tenant.py``) moves exactly when a
tenant's answers die.

Re-evaluation is *incremental and deduplicated*: one evaluation pass
collects every stale window across every tenant — subscribers sharing a
window share one evaluation, so 10k subscribers on 100 distinct windows
cost 100 evaluations — and answers them with ONE cross-tenant
``TenantRegistry.query_many`` merge dispatch (the arena gather pack),
then fans the answers out through bounded per-subscriber delivery
queues.  Overflow policy is explicit per subscription:

* ``coalesce`` (default, the dashboard policy) — a full queue drops its
  *oldest* updates to admit the newest (counted in ``coalesced``);
* ``block`` — delivery waits for the consumer to drain (backpressure
  onto the evaluation worker);
* ``drop`` — the newest update is discarded and counted (``dropped``).

Degraded-mode contract (same as ``query_many(degraded_ok=True)``): a
quarantined tenant's stale subscriptions — and every stale window while
the ``subs.eval`` failpoint is firing — are served the last-known-good
answer as an :class:`~repro_torch.core.resilience.Answer` flagged
``degraded=True`` with honestly widened eps; the subscription stays
stale, so the next tick after the fault heals re-pushes fresh.  A
``subs.deliver`` fault leaves the subscriber at its old version (counted
in ``deliver_failures``); the next evaluation pass re-delivers from the
plane's answer cache without a new dispatch.  Nothing is silently lost.

Event-sequencing (no sleeps anywhere): the evaluation worker is a
single lazily-started daemon thread on the ``IngestPool`` pattern
(``core/workers.py``) — condition-variable wakeups, an epoch counter,
and a :meth:`SubscriptionPlane.flush` barrier that returns only after
every tick submitted before it has been evaluated AND delivered.

Lock ranks (``repro_torch.analysis.witness``): ``subs.cv`` (6) and
``subs.queue`` (8) sit *below* ``registry._lock`` (10) — plane
bookkeeping may call into the registry, never the reverse; the worker
holds neither across the merge dispatch.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterable, NamedTuple

from repro_torch.analysis.witness import OrderedRLock
from repro_torch.core import failpoints as faults

__all__ = ["POLICIES", "Subscription", "SubscriptionPlane", "Update"]

POLICIES = ("coalesce", "block", "drop")


class Update(NamedTuple):
    """One pushed answer: the same ``(hist, eps)`` the pull path reports,
    plus the provenance a dashboard needs to trust it."""

    tenant: str
    lo: int
    hi: int
    beta: int
    hist: object  # Histogram | None (the empty-window placeholder)
    eps: float
    version: object  # store version the answer was evaluated at
    seq: int  # plane-global delivery sequence number
    degraded: bool  # True ⇒ last-known-good serving (Answer contract)
    lag_seconds: float  # staleness mark → delivery


class Subscription:
    """One standing query's delivery endpoint: a bounded queue with an
    explicit overflow policy.  Consumers call :meth:`get` / :meth:`drain`;
    only the plane's evaluation worker enqueues."""

    def __init__(self, plane: "SubscriptionPlane", key, policy, queue_cap):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}: {policy!r}")
        if int(queue_cap) < 1:
            raise ValueError(f"queue_cap must be >= 1: {queue_cap!r}")
        self.plane = plane
        self.key = key  # (tenant, lo, hi, beta)
        self.policy = policy
        self.queue_cap = int(queue_cap)
        # per-subscription delivery condition; keyed by identity so the
        # witness allows (never-needed) same-rank nesting deterministically
        self.cv = threading.Condition(OrderedRLock("subs.queue", key=id(self)))
        self._q: deque[Update] = deque()
        self.closed = False
        self.delivered = 0  # updates enqueued (consumer-visible)
        self.coalesced = 0  # stale updates displaced by newer (coalesce)
        self.dropped = 0  # newest-update discards (drop policy)
        # store version of the last successfully delivered FRESH answer —
        # owned by the evaluation worker thread after construction
        self._last_version: object = None

    # ------------------------------------------------------------ consumer
    def get(self, timeout: float | None = None) -> Update | None:
        """Pop the oldest pending update (blocking).  ``None`` on timeout
        or when the subscription is closed and empty."""
        with self.cv:
            while not self._q and not self.closed:
                if not self.cv.wait(timeout):
                    return None
            if not self._q:
                return None  # closed and empty
            update = self._q.popleft()
            self.cv.notify_all()  # wake a block-policy producer
            return update

    def drain(self) -> list[Update]:
        """Pop everything pending without blocking."""
        with self.cv:
            out = list(self._q)
            self._q.clear()
            if out:
                self.cv.notify_all()
            return out

    def pending(self) -> int:
        with self.cv:
            return len(self._q)

    def stats(self) -> dict:
        with self.cv:
            return {
                "key": self.key,
                "policy": self.policy,
                "pending": len(self._q),
                "delivered": self.delivered,
                "coalesced": self.coalesced,
                "dropped": self.dropped,
                "closed": self.closed,
            }

    # ------------------------------------------------------- plane-internal
    def _offer(self, update: Update, closing: threading.Event) -> bool:
        """Enqueue per policy; False ⇒ not delivered (closed/shutdown)."""
        with self.cv:
            if self.closed:
                return False
            if self.policy == "block":
                while (
                    len(self._q) >= self.queue_cap
                    and not self.closed
                    and not closing.is_set()
                ):
                    self.cv.wait()
                if self.closed or closing.is_set():
                    return False
            elif len(self._q) >= self.queue_cap:
                if self.policy == "coalesce":
                    while len(self._q) >= self.queue_cap:
                        self._q.popleft()
                        self.coalesced += 1
                else:  # drop: the newest update is the counted casualty
                    self.dropped += 1
                    return True
            self._q.append(update)
            self.delivered += 1
            self.cv.notify_all()
            return True

    def close(self) -> None:
        """Mark closed and wake blocked consumers/producers (idempotent)."""
        with self.cv:
            self.closed = True
            self.cv.notify_all()


class SubscriptionPlane:
    """Registry-level standing-query plane (see module docstring).

    Attaches to a :class:`~repro_torch.core.tenant.TenantRegistry` as a
    stale-listener: every registry ingest/sweep/eviction tick calls
    :meth:`mark_stale` with the touched tenant names.  The evaluation
    worker then re-checks *store versions* (the authoritative staleness
    signal — a hint can be missed, a version move cannot), evaluates all
    stale distinct windows with one ``query_many`` dispatch, and fans
    out.  ``registry.close()`` closes attached planes.
    """

    def __init__(self, registry):
        self.registry = registry
        # plane condition: subscription table, dirty hints, epoch barrier
        self.cv = threading.Condition(OrderedRLock("subs.cv"))
        self._subs: dict[tuple, list[Subscription]] = {}
        self._tenant_refs: dict[str, int] = {}  # tenant → live window count
        self._marks: dict[str, float] = {}  # tenant → first stale-mark time
        self._epoch = 0  # bumped per tick/flush; the worker's work signal
        self._completed = 0  # highest epoch fully evaluated AND delivered
        self._closing = threading.Event()
        self._thread: threading.Thread | None = None
        # evaluation-worker-owned state (never touched by other threads):
        # window key → (store version, (hist, eps)) of the last fresh eval
        self._seen: dict[tuple, tuple] = {}
        # ---- counters (GIL-coarse ints; read by stats()/health()) ----
        self.ticks = 0  # mark_stale calls that touched a subscribed tenant
        self.eval_passes = 0  # worker passes that evaluated >= 1 window
        self.eval_batches = 0  # query_many calls (merge dispatch attempts)
        self.windows_evaluated = 0  # distinct stale windows re-evaluated
        self.updates_delivered = 0  # fan-out deliveries accepted by queues
        self.dedup_saved = 0  # subscriber evals saved by window dedup
        self.degraded_pushed = 0  # degraded Answers pushed (quarantine/fault)
        self.eval_failures = 0  # subs.eval faults (pass served degraded)
        self.deliver_failures = 0  # subs.deliver faults (retried next pass)
        self.seq = 0  # plane-global update sequence
        self.last_lag_seconds = 0.0
        self.max_lag_seconds = 0.0
        registry._stale_listeners.append(self)

    # ------------------------------------------------------------- register
    def subscribe(
        self,
        tenant: str,
        lo: int,
        hi: int,
        beta: int,
        *,
        policy: str = "coalesce",
        queue_cap: int = 8,
    ) -> Subscription:
        """Register a standing query; the initial answer is pushed on the
        next tick or :meth:`flush` (subscribing never wakes the worker, so
        between-flush counter accounting stays deterministic)."""
        name = str(tenant)
        # create the tenant eagerly (outside the plane lock: registry._lock
        # ranks above subs.cv only in the plane→registry direction)
        self.registry.tenant(name)
        key = (name, int(lo), int(hi), int(beta))
        sub = Subscription(self, key, policy, queue_cap)
        with self.cv:
            if self._closing.is_set():
                raise RuntimeError("subscription plane is closed")
            self._subs.setdefault(key, []).append(sub)
            self._tenant_refs[name] = self._tenant_refs.get(name, 0) + 1
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        """Remove and close one subscription (idempotent)."""
        with self.cv:
            lst = self._subs.get(sub.key)
            if lst is not None and sub in lst:
                lst.remove(sub)
                name = sub.key[0]
                n = self._tenant_refs.get(name, 1) - 1
                if n:
                    self._tenant_refs[name] = n
                else:
                    self._tenant_refs.pop(name, None)
                if not lst:
                    del self._subs[sub.key]
        sub.close()

    def __len__(self) -> int:
        with self.cv:
            return sum(len(v) for v in self._subs.values())

    # ----------------------------------------------------------- tick plane
    def mark_stale(self, names: Iterable[str] | str) -> None:
        """Registry tick: the named tenants' versions may have moved.
        Cheap when none of them carry subscriptions; otherwise wakes the
        evaluation worker (the hint is a wakeup — version comparison in
        the worker is the authoritative staleness check)."""
        if isinstance(names, str):
            names = (names,)
        now = time.monotonic()
        with self.cv:
            if self._closing.is_set():
                return
            relevant = [
                n for n in map(str, names) if self._tenant_refs.get(n)
            ]
            if not relevant:
                return
            self.ticks += 1
            for n in relevant:
                self._marks.setdefault(n, now)
            self._epoch += 1
            self._ensure_worker()
            self.cv.notify_all()

    def flush(self) -> None:
        """Barrier: every tick submitted before this call has been fully
        evaluated and delivered when it returns.  Also forces one
        evaluation pass, so fresh subscriptions receive their initial
        answer (and faulted deliveries their retry) without a tick.

        A ``block``-policy subscriber that never drains blocks delivery
        and therefore blocks this barrier — that is the policy's contract.
        """
        with self.cv:
            if self._closing.is_set():
                return
            self._epoch += 1
            target = self._epoch
            self._ensure_worker()
            self.cv.notify_all()
            while self._completed < target and not self._closing.is_set():
                self.cv.wait()

    def reattach(self, new_registry) -> None:
        """Re-home this plane onto another registry — the failover leg of
        ``Follower.promote()`` (core/replication.py): live subscriptions
        keep their keys and queues, evaluation continues against the
        promoted registry's stores, and every subscribed tenant is marked
        stale so subscribers receive a fresh post-failover answer (their
        ``version`` counters may regress; ``seq`` stays monotonic).

        The new registry's tenants are created eagerly *before* the swap
        (the evaluation worker assumes subscribed tenants exist), and the
        listener hookup moves atomically under the plane condition.
        """
        with self.cv:
            names = list(self._tenant_refs)
        for name in names:
            new_registry.tenant(name)  # outside cv: registry._lock ranks above
        old = self.registry
        with self.cv:
            if self._closing.is_set():
                return
            self.registry = new_registry
            # force a full re-evaluation: versions on the new registry are
            # not comparable to the cached ones
            self._seen.clear()
            now = time.monotonic()
            for name in names:
                self._marks.setdefault(name, now)
            if names:
                self._epoch += 1
                self._ensure_worker()
                self.cv.notify_all()
        try:
            old._stale_listeners.remove(self)
        except ValueError:
            pass
        new_registry._stale_listeners.append(self)

    def close(self) -> None:
        """Stop the worker (finishing any pending pass), close every
        subscription, detach from the registry.  Idempotent."""
        with self.cv:
            already = self._closing.is_set()
            self._closing.set()
            self.cv.notify_all()
            thread = self._thread
            subs = [s for lst in self._subs.values() for s in lst]
        for sub in subs:
            sub.close()  # wakes block-policy producers and idle consumers
        if thread is not None:
            thread.join()
        if not already:
            try:
                self.registry._stale_listeners.remove(self)
            except ValueError:
                pass

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        """Counters for ``health()``: subscription/window counts, lag,
        dedup and overflow accounting."""
        with self.cv:
            subs = [s for lst in self._subs.values() for s in lst]
            windows = len(self._subs)
            tenants = len(self._tenant_refs)
        pending = coalesced = dropped = 0
        for s in subs:
            st = s.stats()
            pending += st["pending"]
            coalesced += st["coalesced"]
            dropped += st["dropped"]
        return {
            "subscriptions": len(subs),
            "windows": windows,
            "tenants": tenants,
            "ticks": self.ticks,
            "eval_passes": self.eval_passes,
            "eval_batches": self.eval_batches,
            "windows_evaluated": self.windows_evaluated,
            "updates_delivered": self.updates_delivered,
            "dedup_saved": self.dedup_saved,
            "degraded_pushed": self.degraded_pushed,
            "eval_failures": self.eval_failures,
            "deliver_failures": self.deliver_failures,
            "pending": pending,
            "coalesced": coalesced,
            "dropped": dropped,
            "last_lag_seconds": self.last_lag_seconds,
            "max_lag_seconds": self.max_lag_seconds,
        }

    # ---------------------------------------------------- evaluation worker
    def _ensure_worker(self) -> None:
        # caller holds self.cv
        t = self._thread
        if t is None or not t.is_alive():
            t = threading.Thread(
                target=self._loop, name="subs-eval", daemon=True
            )
            self._thread = t
            t.start()

    def _loop(self) -> None:
        while self._run_once():
            pass

    def _run_once(self) -> bool:
        with self.cv:
            while (
                not self._closing.is_set() and self._completed >= self._epoch
            ):
                self.cv.wait()
            if self._closing.is_set() and self._completed >= self._epoch:
                return False  # drained: nothing submitted before close
            target = self._epoch
            table = {k: list(v) for k, v in self._subs.items() if v}
            marks = dict(self._marks)
            self._marks.clear()
        try:
            self._evaluate(table, marks)
        finally:
            with self.cv:
                if target > self._completed:
                    self._completed = target
                self.cv.notify_all()
        return True  # the top-of-loop predicate decides drained-on-close

    def _quarantined(self, name: str) -> bool:
        reg = self.registry
        if reg.breaker_policy is None:
            return False
        with reg._lock:
            b = reg._breakers.get(name)
        return b is not None and b.state != "closed"

    def _evaluate(self, table: dict, marks: dict) -> None:
        """One incremental pass: version-diff every subscribed window,
        answer all stale ones with one ``query_many`` dispatch per beta,
        fan out to every subscriber not already at the answer's version."""
        reg = self.registry
        t_pass = time.monotonic()
        # one version read per distinct subscribed tenant
        versions: dict[str, object] = {}
        for key in table:
            name = key[0]
            if name not in versions:
                versions[name] = (
                    reg[name].version if name in reg else None
                )
        stale = [
            key
            for key in sorted(table)
            if key not in self._seen
            or self._seen[key][0] != versions[key[0]]
        ]
        degraded: dict[tuple, object] = {}  # key → Answer(degraded=True)
        fresh: dict[tuple, tuple] = {}  # key → (version, (hist, eps))
        to_eval: list[tuple] = []
        for key in stale:
            if self._quarantined(key[0]):
                # the quarantine contract: last-known-good, honestly
                # widened, flagged — exactly query_many(degraded_ok=True)
                degraded[key] = reg._degraded_answer(key)
            else:
                to_eval.append(key)
        if to_eval:
            try:
                faults.hit("subs.eval", windows=len(to_eval))
            except BaseException:
                self.eval_failures += 1
                for key in to_eval:
                    degraded[key] = reg._degraded_answer(key)
            else:
                by_beta: dict[int, list[tuple]] = {}
                for key in to_eval:
                    by_beta.setdefault(key[3], []).append(key)
                for beta, keys in sorted(by_beta.items()):
                    # ONE cross-tenant merge dispatch for every stale
                    # window at this beta (the arena gather pack)
                    answers = reg.query_many(
                        [(k[0], k[1], k[2]) for k in keys],
                        beta,
                        strict=False,
                        degraded_ok=True,
                    )
                    self.eval_batches += 1
                    for key, ans in zip(keys, answers):
                        if getattr(ans, "degraded", False):
                            degraded[key] = ans
                        else:
                            fresh[key] = (versions[key[0]], ans)
            self.eval_passes += 1
            self.windows_evaluated += len(to_eval)
            self.dedup_saved += sum(
                len(table[k]) - 1 for k in to_eval
            )
        for key, (version, ans) in fresh.items():
            self._seen[key] = (version, ans)
        # fan-out: every subscriber whose delivered version lags the
        # answer's version gets an update; degraded answers never advance
        # the subscriber's version (the window stays stale until healed)
        for key in sorted(table):
            name, lo, hi, beta = key
            if key in degraded:
                ans, version, is_degraded = degraded[key], None, True
            elif key in self._seen:
                version, ans = self._seen[key]
                is_degraded = False
            else:
                continue  # never evaluated (eval itself unavailable)
            mark_t = marks.get(name, t_pass)
            for sub in table[key]:
                if not is_degraded and sub._last_version == version:
                    continue  # already current — their result isn't stale
                self.seq += 1
                now = time.monotonic()
                lag = max(0.0, now - mark_t)
                update = Update(
                    name, lo, hi, beta,
                    ans[0], float(ans[1]),
                    version, self.seq, is_degraded, lag,
                )
                try:
                    faults.hit(
                        "subs.deliver", tenant=name, policy=sub.policy
                    )
                    ok = sub._offer(update, self._closing)
                except BaseException:
                    # leave sub._last_version stale: the next pass
                    # re-delivers from self._seen without a new dispatch
                    self.deliver_failures += 1
                    continue
                if not ok:
                    continue  # closed mid-delivery
                self.updates_delivered += 1
                if is_degraded:
                    self.degraded_pushed += 1
                else:
                    sub._last_version = version
                self.last_lag_seconds = lag
                if lag > self.max_lag_seconds:
                    self.max_lag_seconds = lag
        # prune evaluation cache entries whose last subscriber left
        for key in list(self._seen):
            if key not in table:
                del self._seen[key]
