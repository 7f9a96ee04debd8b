"""Runtime lock-discipline witness: rank-ordered lock wrappers.

The port's copy of ``repro.analysis.witness``: the same ranks and lock
names, so the two packages share one documented hierarchy.

The serving plane's documented lock hierarchy (ANALYSIS.md) is only a
comment until something *checks* it.  This module provides drop-in
wrappers — :class:`OrderedLock` / :class:`OrderedRLock` — that carry a
numeric **rank** (and, for same-rank families like the per-tenant store
locks, a sortable **key**) and assert on every ``acquire`` that the
calling thread only ever acquires locks in strictly increasing rank
order (ascending key order within a rank).  A violation raises
:class:`LockOrderError` immediately, at the acquisition site, with both
sides of the inversion named — instead of a once-a-month deadlock in CI.

Cost model (the reason this can wrap *production* locks, not test
doubles): the witness is **disarmed by default** and the disarmed
``acquire``/``release`` fast path is a single module-global read
(``if _ARMED:``) on top of the raw lock call.  ``benchmarks/faults.py``
measures and schema-gates that claim next to the failpoint overhead.
The whole test suite arms it via ``REPRO_LOCK_WITNESS=1`` (see
``tests/conftest.py``), so every lock acquisition the suite drives —
including the chaos lane's crash/retry interleavings — doubles as a
hierarchy check.

Deliberately stdlib-only and import-free of ``repro_torch.core`` (core modules
import *this*; a cycle here would be an import-order landmine).
"""
from __future__ import annotations

import threading

__all__ = [
    "LockOrderError",
    "OrderedLock",
    "OrderedRLock",
    "RANKS",
    "arm",
    "disarm",
    "armed",
    "acquire_count",
    "reset_acquire_count",
    "held_locks",
]


class LockOrderError(AssertionError):
    """A thread acquired a lock out of the documented rank order."""


# The documented hierarchy (see ANALYSIS.md for the diagram and the
# rationale per edge).  Lower rank = acquired first (outermost).  Gaps
# are deliberate — future locks slot in without renumbering.
RANKS: dict[str, int] = {
    "repl.replicator": 2,       # Replicator._lock (ship serialization)
    "repl.follower": 4,         # Follower._lock (tail/apply state)
    "repl.dirgate": 5,          # per-follower-dir send-vs-fence gate
    "subs.cv": 6,               # SubscriptionPlane.cv's underlying RLock
    "subs.queue": 8,            # Subscription.cv (delivery queue, key=id)
    "registry._lock": 10,       # TenantRegistry._lock (RLock)
    "store._lock": 20,          # HistogramStore._lock (RLock, key=tenant)
    "pool.ingest_mutex": 30,    # IngestPool.ingest_mutex
    "pool._state_lock": 32,     # IngestPool._state_lock
    "pool.cv": 34,              # IngestPool.cv's underlying RLock
    "wal._commit_lock": 40,     # WriteAheadLog._commit_lock (group commit)
    "wal._lock": 42,            # WriteAheadLog._lock (append/rotate)
    "arena._lock": 50,          # NodeArena._lock (RLock)
    "faults.registry": 70,      # faults._LOCK (failpoint table)
}

_ARMED = False  # the disarmed fast path is this one module-global read

# armed-mode acquisition counter (read by benchmarks/faults.py to bound
# the witness overhead analytically; GIL-coarse increments are fine for
# that purpose)
_ACQUIRES = 0


class _Held(threading.local):
    def __init__(self):
        # acquisition-ordered stack of (lock, rank, key, name)
        self.stack: list[tuple[object, int, object, str]] = []


_TLS = _Held()


def arm() -> None:
    """Enable order checking globally (all wrapped locks, all threads)."""
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def armed() -> bool:
    return _ARMED


def acquire_count() -> int:
    return _ACQUIRES


def reset_acquire_count() -> None:
    global _ACQUIRES
    _ACQUIRES = 0


def held_locks() -> list[str]:
    """Names of wrapped locks the calling thread holds (debug aid)."""
    return [name for _l, _r, _k, name in _TLS.stack]


class _OrderedBase:
    """Shared acquire/release/order-check machinery.

    Also speaks :class:`threading.Condition`'s custom-lock protocol
    (``_is_owned`` / ``_release_save`` / ``_acquire_restore``) so an
    ``OrderedRLock`` can back a Condition: ``wait()`` transparently pops
    the witness stack while the lock is released and re-checks order on
    re-acquisition.
    """

    _reentrant = False

    __slots__ = ("_raw", "name", "rank", "key")

    def __init__(self, name: str, rank: int | None = None, key=None):
        if rank is None:
            rank = RANKS[name]
        self._raw = self._make_raw()
        self.name = name
        self.rank = rank
        self.key = key  # sortable id within a same-rank family (or None)

    @staticmethod
    def _make_raw():
        raise NotImplementedError

    # ------------------------------------------------------------- checks
    def _check_order(self) -> None:
        held = _TLS.stack
        if not held:
            return
        if any(entry[0] is self for entry in held):
            if self._reentrant:
                return  # re-entering a lock we own is always fine
            raise LockOrderError(
                f"self-deadlock: thread already holds non-reentrant "
                f"{self.name!r} (held: {held_locks()})"
            )
        top = max(entry[1] for entry in held)
        if self.rank > top:
            return
        if self.rank == top:
            same = [e for e in held if e[1] == self.rank]
            if self.key is not None and all(
                e[2] is not None and e[2] < self.key for e in same
            ):
                return  # ascending-key acquisition within the rank family
            raise LockOrderError(
                f"same-rank order violation: acquiring {self.name!r} "
                f"(rank {self.rank}, key {self.key!r}) while holding "
                f"{[(e[3], e[2]) for e in same]!r} — same-rank locks must "
                f"be keyed and taken in ascending key order"
            )
        raise LockOrderError(
            f"lock-rank inversion: acquiring {self.name!r} (rank "
            f"{self.rank}) while holding rank {top} (held: "
            f"{held_locks()}) — see ANALYSIS.md lock hierarchy"
        )

    # ---------------------------------------------------------- lock API
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _ARMED:
            self._check_order()
        got = self._raw.acquire(blocking, timeout)
        if got and _ARMED:
            global _ACQUIRES
            _ACQUIRES += 1
            _TLS.stack.append((self, self.rank, self.key, self.name))
        return got

    def release(self):
        self._raw.release()
        if _ARMED:
            held = _TLS.stack
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self:
                    del held[i]
                    break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._raw.locked()

    def __repr__(self):
        return (
            f"<{type(self).__name__} {self.name!r} rank={self.rank} "
            f"key={self.key!r}>"
        )

    # ----------------------- threading.Condition custom-lock protocol
    def _is_owned(self):
        return self._raw._is_owned()

    def _release_save(self):
        # Condition.wait releases the lock fully (all recursion levels);
        # pop every witness entry for this lock and remember how many so
        # _acquire_restore can rebalance the stack.
        depth = 0
        if _ARMED:
            held = _TLS.stack
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self:
                    del held[i]
                    depth += 1
        return (self._raw._release_save(), depth)

    def _acquire_restore(self, saved):
        state, depth = saved
        if _ARMED:
            self._check_order()
        self._raw._acquire_restore(state)
        if _ARMED:
            global _ACQUIRES
            _ACQUIRES += 1
            entry = (self, self.rank, self.key, self.name)
            _TLS.stack.extend([entry] * max(depth, 1))


class OrderedLock(_OrderedBase):
    """Rank-checked wrapper over :class:`threading.Lock`."""

    _reentrant = False
    __slots__ = ()

    @staticmethod
    def _make_raw():
        return threading.Lock()


class OrderedRLock(_OrderedBase):
    """Rank-checked wrapper over :class:`threading.RLock`.

    Usable as the backing lock of a :class:`threading.Condition`.
    """

    _reentrant = True
    __slots__ = ()

    @staticmethod
    def _make_raw():
        return threading.RLock()

    def locked(self):  # RLock grew .locked() only in 3.12 — emulate
        if self._raw.acquire(blocking=False):
            self._raw.release()
            return False
        return True
