"""Self-healing primitives: bounded retry, circuit breaker, degraded answers.

The fault-injection plane (core/faults.py) makes runtime faults
reproducible; this module holds the *responses* the serving plane mounts
against them, all deterministic and clock/sleep-injectable so every
behavior is testable without real time passing:

* :class:`RetryPolicy` — bounded attempts with exponential backoff and
  seeded jitter.  The WAL retries transient fsync failures, the ingest
  pool retries suspect batch items, and both sleep through an
  *interruptible* wait (a ``threading.Event``), so ``close()`` never has
  to out-wait a backoff (core/workers.py).
* :class:`CircuitBreaker` / :class:`BreakerPolicy` — the per-tenant
  quarantine state machine (closed → open → half-open probe → closed).
  A tenant whose ingests keep failing trips its breaker: further submits
  are rejected at the door (:class:`TenantQuarantined`) instead of
  riding into shared batches and poisoning co-batched tenants; after a
  cooldown one probe is allowed through, and a probe success closes the
  breaker.
* :class:`Answer` — a ``(histogram, eps_total)`` pair that still unpacks
  like the historical 2-tuple but carries a ``degraded`` flag: when the
  merge dispatch fails (or a deadline has already passed), the registry
  serves the last known-good answer with an **honestly widened**
  ``eps_total`` — the cached bound plus the total mass added to and
  removed from the interval since the answer was computed, which bounds
  any bucket/range drift the staleness can have introduced — rather than
  raising.  ``degraded`` is never set on a freshly-merged answer, which
  is what lets the chaos harness assert that every non-degraded answer
  bit-matches a fault-free replica.
* :class:`IngestBackpressure` — raised to the *submitter* when durable
  ingest cannot make its ack true (the WAL append/fsync failed after
  retries).  A sick disk pushes back on producers instead of queueing
  acked-but-undurable partitions without bound.  The exception carries
  ``retry_after`` — the backoff the exhausted retry schedule would have
  slept next — so callers (and the replication shipper) can pace their
  resubmit instead of hot-looping; ``health()["backpressure"]`` mirrors
  the latest rejection for dashboards.
* :class:`PrimaryFenced` / :class:`NotPrimary` — the replication plane's
  epoch-fencing contract (core/replication.py): after a failover
  ``promote()`` stamps the new epoch and fences the deposed primary,
  whose late WAL appends are rejected with :class:`PrimaryFenced`
  (never retried, never wrapped in backpressure — the split-brain must
  surface, not pace).  :class:`NotPrimary` rejects ingest on a
  replica-role service.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

__all__ = [
    "Answer",
    "BreakerPolicy",
    "CircuitBreaker",
    "IngestBackpressure",
    "NotPrimary",
    "PrimaryFenced",
    "RetryPolicy",
    "TenantQuarantined",
]


class IngestBackpressure(RuntimeError):
    """Durable ingest rejected: the WAL could not make the ack true
    (append or fsync failed after bounded retries).  Nothing was
    enqueued — the caller owns the partition and may resubmit.

    ``retry_after`` (seconds, ``None`` when unknown) is the pacing hint:
    the backoff delay the exhausted retry schedule would have applied
    next.  Callers that resubmit sooner are hot-looping against a disk
    that just refused this exact work.
    """

    def __init__(self, message: str, *, retry_after: float | None = None):
        super().__init__(message)
        self.retry_after = retry_after


class PrimaryFenced(RuntimeError):
    """WAL append rejected by epoch fencing: a follower was promoted at
    a higher epoch than this (now deposed) primary's.  Not a transient
    fault — the caller must stop writing, not retry."""

    def __init__(self, epoch: int, fence_epoch: int):
        super().__init__(
            f"primary fenced: log epoch {epoch} < fence epoch "
            f"{fence_epoch} (a follower was promoted)"
        )
        self.epoch = int(epoch)
        self.fence_epoch = int(fence_epoch)


class NotPrimary(RuntimeError):
    """Write rejected: this service runs in ``role="replica"`` and only
    the primary accepts ingest (promote() flips the role)."""


class TenantQuarantined(RuntimeError):
    """Submit rejected by the tenant's open circuit breaker."""

    def __init__(self, tenant: str, state: str):
        super().__init__(
            f"tenant {tenant!r} is quarantined (breaker {state})"
        )
        self.tenant = tenant
        self.state = state


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``attempts`` counts *total* tries (1 = no retry).  Delay before retry
    ``i`` (1-based) is ``min(cap, base * 2**(i-1))`` scaled by a jitter
    factor drawn uniformly from ``[1 - jitter, 1]`` — deterministic for a
    given ``seed``, so tests and the chaos harness replay exact schedules.
    """

    attempts: int = 3
    base: float = 0.01
    cap: float = 1.0
    jitter: float = 0.5
    seed: int = 0

    def delays(self) -> Iterator[float]:
        """The ``attempts - 1`` backoff delays, in order."""
        rng = random.Random(self.seed)
        for i in range(max(0, self.attempts - 1)):
            d = min(self.cap, self.base * (2.0**i))
            if self.jitter > 0.0:
                d *= 1.0 - self.jitter * rng.random()
            yield d

    def retry_after(self) -> float:
        """The (un-jittered) backoff that would follow the final attempt
        — the pacing hint :class:`IngestBackpressure` hands callers when
        this schedule is exhausted."""
        return min(self.cap, self.base * (2.0 ** max(0, self.attempts - 1)))


def retry_call(
    fn: Callable[[], object],
    policy: RetryPolicy,
    *,
    wait: Callable[[float], object] | None = None,
    retryable: Callable[[BaseException], bool] | None = None,
    on_retry: Callable[[int, BaseException], None] | None = None,
):
    """Run ``fn`` under ``policy``; re-raise the last failure when the
    attempt budget is spent.

    ``wait(delay)`` is the backoff sleep — pass an interruptible wait
    (e.g. ``closing_event.wait``) so a concurrent shutdown cuts the
    backoff short; the *remaining attempts still run* (immediately), so
    bounding the wait never drops the retried work.  ``retryable`` may
    veto retrying a permanent error; ``on_retry(attempt, exc)`` is the
    counter hook.
    """
    delays = list(policy.delays())
    last: BaseException | None = None
    for attempt in range(max(1, policy.attempts)):
        try:
            return fn()
        except BaseException as e:
            last = e
            if retryable is not None and not retryable(e):
                raise
            if attempt >= len(delays):
                raise
            if on_retry is not None:
                on_retry(attempt + 1, e)
            if wait is None:
                time.sleep(delays[attempt])
            else:
                wait(delays[attempt])
    raise last  # not reachable: the loop always returns or raises


@dataclass(frozen=True)
class BreakerPolicy:
    """Configuration of the per-tenant :class:`CircuitBreaker`.

    ``threshold`` consecutive failures open the breaker; after
    ``cooldown`` seconds (by ``clock``, injectable for deterministic
    tests) the next ``allow`` admits up to ``probes`` half-open probe
    submits; a recorded success closes the breaker, a failure re-opens
    it for another cooldown.
    """

    threshold: int = 5
    cooldown: float = 30.0
    probes: int = 1
    clock: Callable[[], float] = time.monotonic


class CircuitBreaker:
    """closed → open → half-open → closed, one instance per tenant.

    Thread-safe; every transition is driven by ``allow``/``record_*``
    calls only (no timers), so behavior is fully deterministic under an
    injected clock.
    """

    def __init__(self, policy: BreakerPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0  # consecutive, while closed
        self.opened_at = 0.0
        self.probes_in_flight = 0
        self.trips = 0  # closed/half-open → open transitions

    def allow(self) -> bool:
        """May a submit for this tenant proceed right now?  Open breakers
        transition to half-open by themselves once the cooldown elapsed
        (the probe budget admits the caller that observed it)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                now = self.policy.clock()
                if now - self.opened_at < self.policy.cooldown:
                    return False
                self.state = "half_open"
                self.probes_in_flight = 0
            # half-open: admit up to `probes` concurrent probe submits
            if self.probes_in_flight < self.policy.probes:
                self.probes_in_flight += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state == "half_open":
                self.state = "closed"
            self.failures = 0
            self.probes_in_flight = 0

    def record_failure(self) -> None:
        with self._lock:
            if self.state == "half_open":
                self._trip()
                return
            self.failures += 1
            if self.state == "closed" and (
                self.failures >= self.policy.threshold
            ):
                self._trip()

    def _trip(self) -> None:
        self.state = "open"
        self.opened_at = self.policy.clock()
        self.failures = 0
        self.probes_in_flight = 0
        self.trips += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "failures": self.failures,
                "trips": self.trips,
            }


class Answer(tuple):
    """``(histogram, eps_total)`` that unpacks like the historical
    2-tuple, plus the degraded-serving metadata.  Fresh answers stay
    plain tuples (zero overhead); only the degraded path allocates these.
    """

    degraded = False  # class default: plain answers read False
    stale_version: int | None = None  # store version the cached answer saw
    lag_seconds: float | None = None  # replication lag (replica-served)

    @property
    def histogram(self):
        return self[0]

    @property
    def eps(self) -> float:
        return self[1]

    @staticmethod
    def make(hist, eps: float, *, degraded: bool, stale_version=None,
             lag_seconds=None):
        a = Answer((hist, eps))
        a.degraded = degraded
        a.stale_version = stale_version
        a.lag_seconds = lag_seconds
        return a
