"""Deterministic failpoint injection — the chaos plane's one entry point.

The port's copy of ``repro.core.faults`` (same sites, same semantics),
imported as ``faults``.  It carries another file name so that the
repository holds one ``faults.py`` registry.

A production serving plane only honors the paper's error guarantee if it
keeps honoring it under partial failure: disk-full WAL appends, torn
writes, crashed ingest workers, corrupted snapshots, poisoned tenants.
Those faults are rare and timing-dependent in the wild, which is exactly
why they must be *injectable on demand and deterministically* in tests
and benchmarks.  This module is the named-failpoint registry every
fault-tolerant layer threads through:

    core/workers.py   wal.append / wal.append.torn / wal.fsync /
                      pool.batch / pool.retry
    core/arena.py     arena.alloc / arena.rows / arena.gather
    core/tenant.py    tenant.merge / tenant.apply
    core/stream.py    snapshot.save / snapshot.save.corrupt / snapshot.load
    checkpoint/       checkpoint.save / checkpoint.restore
    core/replication.py  repl.ship / repl.tail / repl.apply / repl.promote

Design rules
------------
* **Zero overhead when disarmed.**  Every site calls :func:`hit`, whose
  fast path is one module-global boolean read — nothing armed means no
  dict lookup, no lock, no allocation.  BENCH_faults.json machine-checks
  that the disabled framework costs ≤ 1 % on the ingest and query paths.
* **Deterministic triggers.**  A failpoint fires on an explicit schedule:
  ``times`` (first N matching hits), ``after`` (skip the first N),
  ``prob`` with a **seeded** per-failpoint RNG, or any combination.  The
  same seed and the same hit sequence produce the same fault schedule —
  the chaos property test replays schedules byte-for-byte.
* **Context filtering.**  Sites pass keyword context
  (``hit("tenant.apply", tenant=name)``); an armed failpoint may carry a
  ``match`` predicate over that context, so a test can poison exactly one
  tenant without touching the shared batch machinery.
* **Scoped arming.**  :func:`inject` is a context manager; on exit the
  failpoint is disarmed and the global flag drops back when the registry
  empties.  Nesting arms independent failpoints; re-arming the same name
  replaces the previous spec (last-in wins, restored on exit).

A failpoint either **raises** (``exc=``: an exception instance — re-used
as-is — or a zero-arg factory) or **acts** (``action=``: a zero-arg or
context-kwargs callable whose return value the site receives from
``hit``; sites use this for partial-effect faults like torn writes, where
the action returns how many bytes to write before the simulated crash).
``hit`` returns ``default`` when nothing fires, so sites read naturally::

    torn = faults.hit("wal.append.torn")     # None unless armed+triggered
    faults.hit("wal.fsync")                  # raises when armed+triggered

Observability: every :class:`Failpoint` counts ``hits`` (site reached)
and ``fires`` (fault actually delivered); :func:`stats` snapshots the
whole registry for the chaos harness and ``health()`` surfaces.
"""
from __future__ import annotations

import random
from typing import Callable

from repro_torch.analysis.witness import OrderedLock

__all__ = [
    "FaultError",
    "Failpoint",
    "SITES",
    "fires",
    "hit",
    "inject",
    "is_armed",
    "reset",
    "stats",
]

# The declared failpoint sites — the single source of truth.  Every
# ``hit(name)`` call in src/ must name a member, every member must have a
# live call site, and every member must be referenced by at least one
# test; ``scripts/analyze.py``'s failpoint rule enforces all three, so a
# renamed or orphaned site fails CI instead of silently never firing.
SITES: frozenset[str] = frozenset({
    "wal.append",
    "wal.append.torn",
    "wal.fsync",
    "pool.batch",
    "pool.retry",
    "arena.alloc",
    "arena.rows",
    "arena.gather",
    "tenant.apply",
    "tenant.merge",
    "subs.eval",
    "subs.deliver",
    "snapshot.save",
    "snapshot.save.corrupt",
    "snapshot.load",
    "checkpoint.save",
    "checkpoint.restore",
    "repl.ship",
    "repl.tail",
    "repl.apply",
    "repl.promote",
})


class FaultError(Exception):
    """Default injected-fault type (sites never raise this themselves)."""


# fast-path flag: hit() reads this one global before anything else, so a
# fully-disarmed process pays a single boolean check per site
_ARMED = False
_LOCK = OrderedLock("faults.registry")
_REGISTRY: dict[str, "Failpoint"] = {}


class Failpoint:
    """One armed failpoint: trigger schedule + effect + counters."""

    def __init__(
        self,
        name: str,
        *,
        exc: BaseException | Callable[[], BaseException] | None = None,
        action: Callable | None = None,
        times: int | None = None,
        after: int = 0,
        prob: float = 1.0,
        seed: int = 0,
        match: Callable[[dict], bool] | None = None,
    ):
        if exc is not None and action is not None:
            raise ValueError("a failpoint raises OR acts, not both")
        if exc is None and action is None:
            exc = FaultError(name)
        self.name = name
        self.exc = exc
        self.action = action
        self.times = None if times is None else int(times)  # fires budget
        self.after = int(after)  # matching hits to skip before firing
        self.prob = float(prob)
        self.match = match
        self._rng = random.Random(seed)  # per-failpoint: schedules replay
        self.hits = 0  # site reached (post-match)
        self.fires = 0  # fault delivered

    def _check(self, ctx: dict):
        """(triggered, effect) under the registry lock."""
        if self.match is not None and not self.match(ctx):
            return False
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fires += 1
        return True


def hit(name: str, default=None, **ctx):
    """Failpoint site: raise or return the armed effect, else ``default``.

    The disarmed fast path is one global boolean read.  Armed, the
    trigger decision runs under the registry lock (counters and the
    seeded RNG stay race-free); the effect itself — raising ``exc`` or
    calling ``action`` — runs outside it, so an action may sleep or
    re-enter arbitrary code without holding the chaos plane's lock.
    """
    if not _ARMED:
        return default
    with _LOCK:
        fp = _REGISTRY.get(name)
        if fp is None or not fp._check(ctx):
            return default
        exc, action = fp.exc, fp.action
    if exc is not None:
        raise exc() if callable(exc) else exc
    try:
        return action(**ctx)
    except TypeError:
        if ctx:  # zero-arg action at a context-passing site
            return action()
        raise


class _Scope:
    """Context manager returned by :func:`inject` — disarm on exit,
    restoring whatever the name was armed with before (nesting-safe)."""

    def __init__(self, fp: Failpoint):
        global _ARMED
        self.fp = fp
        with _LOCK:
            self.prev = _REGISTRY.get(fp.name)
            _REGISTRY[fp.name] = fp
            _ARMED = True

    def __enter__(self) -> Failpoint:
        return self.fp

    def __exit__(self, *exc_info) -> None:
        global _ARMED
        with _LOCK:
            if _REGISTRY.get(self.fp.name) is self.fp:
                if self.prev is None:
                    _REGISTRY.pop(self.fp.name, None)
                else:
                    _REGISTRY[self.fp.name] = self.prev
            if not _REGISTRY:
                _ARMED = False


def inject(
    name: str,
    *,
    exc: BaseException | Callable[[], BaseException] | None = None,
    action: Callable | None = None,
    times: int | None = None,
    after: int = 0,
    prob: float = 1.0,
    seed: int = 0,
    match: Callable[[dict], bool] | None = None,
) -> _Scope:
    """Arm ``name`` for the duration of the returned context manager.

    >>> with faults.inject("wal.fsync", exc=OSError(28, "No space"),
    ...                    times=2):
    ...     store.ingest(0, values)     # first two fsyncs fail
    """
    return _Scope(
        Failpoint(
            name,
            exc=exc,
            action=action,
            times=times,
            after=after,
            prob=prob,
            seed=seed,
            match=match,
        )
    )


def is_armed(name: str) -> bool:
    if not _ARMED:
        return False
    with _LOCK:
        return name in _REGISTRY


def fires(name: str) -> int:
    """Faults delivered by the currently-armed failpoint (0 if disarmed)."""
    with _LOCK:
        fp = _REGISTRY.get(name)
        return 0 if fp is None else fp.fires


def stats() -> dict[str, dict[str, int]]:
    """Registry snapshot: ``{name: {hits, fires}}`` for armed failpoints."""
    with _LOCK:
        return {
            name: {"hits": fp.hits, "fires": fp.fires}
            for name, fp in _REGISTRY.items()
        }


def reset() -> None:
    """Disarm everything (test teardown belt-and-braces)."""
    global _ARMED
    with _LOCK:
        _REGISTRY.clear()
        _ARMED = False
