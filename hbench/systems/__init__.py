"""Adapters from the harness to each kind of system a configuration names.

Every adapter module under ``systems/`` defines ``System(cfg, device)``:

- ``warm(pool, traffic)``: run every kind of call the cell makes, at its
  shapes, on a throwaway system;
- ``ingest(pid, parts, mode)``: partition ``pid`` of every tenant
  (``parts[t]``), in one of the adapter's modes; returns the summaries a
  synchronous ingest hands back, ``(tenant, pid, boundaries, sizes)``;
- ``query_many([(t, lo, hi)], beta)`` and, optionally, ``query(t, lo, hi,
  beta)``: answers ``(boundaries, sizes, eps)``;
- ``retained(t)``: the summaries the system holds, ``{pid: (b, s)}``;
- ``counters()``: every counter the program keeps (:func:`program_counters`),
  with the answer cache's as ``cache_hits`` and ``cache_misses``, and every
  span total and counter of ``repro_torch.core.spans`` (``span_ns.<span>``,
  ``span_calls.<span>``, ``span_self_ns.<span>``, ``<counter>``);
- ``close()``.

An adapter of a served model says so with ``KIND = "model"``; the harness
runs its cells through ``serving.py``, and it defines ``System(cfg,
traffic, params, device)`` (``params``: the weights the harness made from
the seed, in the program's tree layout) with:

- ``generate(prompts)``: one turn, a list of token-id arrays; returns each
  prompt followed by the tokens served after it;
- ``warm(prompts)``: a throwaway turn that runs every kernel and shape of
  one;
- ``counters()`` and ``close()``, as above.
"""
from __future__ import annotations


def program_counters(cache_stats: dict, **more) -> dict:
    """The program's kernel launches by name, ``cache_stats`` (a store's
    ``cache_stats()``, or ``spans.snapshot()`` alone; hits and misses as
    ``cache_hits``, ``cache_misses``) and ``more``."""
    from repro_torch.kernels import _lib

    cache = {("cache_" + k if k in ("hits", "misses") else k): v for k, v in cache_stats.items()}
    return {**_lib.LAUNCHES, **cache, **more}
