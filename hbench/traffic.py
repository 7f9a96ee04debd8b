"""The one generator of every traffic mix.

A mix is a JSON file under ``traffic/``.  Set-up ingests ``fill.days``
partition ids of every tenant (``fill.mode``: whatever the system's
adapter takes, such as ``sync``, ``async`` or ``summary``).  Its ``loop``
says how the window drives the system:

- ``closed``: one step after another.  A step ingests the next partition
  id of every tenant (``ingest``: the adapter's mode); with ``publish`` it
  then asks for the windows that ``publish`` draws (below) at ``beta``
  buckets: one ``query`` where the adapter has it and there is one
  window, else one ``query_many``.
- ``open``: requests arrive as a Poisson stream of ``rate_per_s``, whatever
  the system does.  A request is one window of the tenant that ``tenants``
  draws, or (``tenants.kind == "all"``) that window of every tenant; the
  window is drawn by ``windows``.  With ``ingest`` (``every_s``, ``mode``)
  a new partition id of every tenant is ingested that often beside the
  requests, and windows follow the newest partition.  ``check_answers``
  requests, drawn from the seed, are judged.

Windows are drawn as offsets inside the newest ``days`` partition ids (0 the
oldest of them) by a generator named in :data:`WINDOWS`; tenants by one in
:data:`TENANTS`.  Everything random is drawn from the seed before the
window opens.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class OpenSchedule:
    due: np.ndarray  # seconds from the window's start, one a request, ascending
    first: np.ndarray  # index of each request's first window, and the end last
    tenant: np.ndarray  # one a window
    lo: np.ndarray  # offsets inside the newest ``days`` partition ids
    hi: np.ndarray
    check: np.ndarray  # indices of the requests the reference judges


def month_windows(days: int) -> np.ndarray:
    """Every ``[lo, hi]`` with ``0 <= lo <= hi < days``, as ``(W, 2)``."""
    lo, hi = np.triu_indices(days)
    return np.stack([lo, hi], axis=1)


def _uniform_windows(rng, count: int, days: int):
    # every window inside the newest ``days`` equally likely
    pick = month_windows(days)[rng.integers(0, days * (days + 1) // 2, size=count)]
    return pick[:, 0].copy(), pick[:, 1].copy()


def _recent_windows(rng, count: int, days: int, lengths: list[int]):
    # the newest L partitions, L drawn uniformly from ``lengths``
    L = np.asarray(lengths, np.int64)[rng.integers(0, len(lengths), size=count)]
    return days - L, np.full(count, days - 1, np.int64)


def _newest_windows(rng, count: int, days: int):
    # the whole of the newest ``days`` partitions
    return np.zeros(count, np.int64), np.full(count, days - 1, np.int64)


WINDOWS = {"uniform": _uniform_windows, "recent": _recent_windows, "newest": _newest_windows}


def _one_tenant(rng, count: int, tenants: int):
    return np.zeros(count, np.int64)


def _zipf_tenants(rng, count: int, tenants: int, s: float):
    # rank r is tenant r - 1
    p = 1.0 / np.arange(1, tenants + 1, dtype=np.float64) ** float(s)
    return rng.choice(tenants, size=count, p=p / p.sum())


TENANTS = {"one": _one_tenant, "zipf": _zipf_tenants}


def draw(table: dict, spec: dict, rng, count: int, *args):
    kw = dict(spec)
    return table[kw.pop("kind")](rng, count, *args, **kw)


def open_schedule(traffic: dict, tenants: int, seconds: float, seed: int) -> OpenSchedule:
    rng = np.random.default_rng([int(seed), 0x7A11])
    rate = float(traffic["rate_per_s"])
    # arrivals until the window closes: gaps Exp(1/rate), drawn in bulk
    n = int(rate * seconds + 10 * np.sqrt(rate * seconds) + 16)
    due = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while due[-1] < seconds:
        due = np.concatenate([due, due[-1] + np.cumsum(rng.exponential(1.0 / rate, size=n))])
    due = due[due < seconds]
    R = due.shape[0]
    spec = traffic["tenants"]
    if spec["kind"] == "all":  # one window a request, asked of every tenant
        lo, hi = draw(WINDOWS, traffic["windows"], rng, R, int(traffic["days"]))
        tenant = np.tile(np.arange(tenants), R)
        lo, hi, width = np.repeat(lo, tenants), np.repeat(hi, tenants), tenants
    else:
        tenant = draw(TENANTS, spec, rng, R, tenants)
        lo, hi = draw(WINDOWS, traffic["windows"], rng, R, int(traffic["days"]))
        width = 1
    k = min(int(traffic["check_answers"]), R)
    check = np.sort(rng.choice(R, size=k, replace=False))
    return OpenSchedule(due, np.arange(R + 1) * width, tenant, lo, hi, check)
