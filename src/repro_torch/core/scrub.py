"""Integrity scrubber: checksum persisted payloads and live arena planes.

The durability chain (WAL → snapshot → arena rows) assumes bytes stay
what they were written as.  Disks and heaps disagree often enough that a
production plane *scrubs*: every :class:`~repro_torch.core.stream.StoredSummary`
carries a CRC computed when it was summarized, every snapshot written by
``atomic_savez`` embeds per-array CRCs in its meta, and this module walks
both and reports (or repairs) what no longer matches.

Three layers, three checks
--------------------------
* :func:`verify_snapshot` — re-reads an npz written by ``atomic_savez``
  and compares each payload array against the ``payload_crc`` map in its
  meta.  An unreadable or checksum-failing snapshot is *corrupt*;
  ``TenantRegistry.recover(..., salvage=True)`` (and therefore
  ``serve.HistogramService``) moves it aside and rebuilds from the WAL
  alone rather than serving wrong answers.
* :func:`scrub_store` — recomputes each in-memory summary's CRC and
  compares the tree's leaf arena row against the summary bits (the
  pooled row is a write-once copy; a mismatch means the plane — or the
  summary — was corrupted in memory).
* :func:`scrub_divergence` — the replication cross-check: checksums
  every tenant/partition summary on a primary registry against a
  follower's (same CRC currency as :func:`scrub_store`), reporting
  partitions whose bits diverge and partitions only one side holds.
  Partitions the follower simply hasn't applied yet are *lag*, not
  divergence — they appear under ``behind`` so the caller can separate
  "catching up" from "corrupted in flight".
* :func:`scrub_registry` — runs :func:`scrub_store` over every tenant
  and, with ``repair=True``, routes each corrupted tenant through
  **WAL-replay rebuild**: the corrupted partitions are dropped, the
  tenant's tree is rebuilt from the surviving (verified) summaries, and
  any WAL record still on disk for a dropped partition is re-ingested —
  the same idempotent-replay contract recovery uses (core/workers.py).
  Partitions whose WAL segments were already truncated by a (healthy)
  snapshot cannot be re-summarized from raw values; they stay dropped
  and are reported, which degrades those windows honestly
  (``strict=False`` serving skips them) instead of serving bit-rot.
"""
from __future__ import annotations

import binascii
import json

import numpy as np

__all__ = [
    "checksum_array",
    "scrub_divergence",
    "scrub_registry",
    "scrub_store",
    "verify_snapshot",
]


def checksum_array(*arrays) -> int:
    """CRC32 over the raw bytes of each array, with dtype/shape mixed in
    (a reshaped or re-typed row must not collide)."""
    crc = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        crc = binascii.crc32(
            f"{a.dtype.str}{a.shape}".encode(), crc
        )
        crc = binascii.crc32(a.tobytes(), crc)
    return crc


def payload_checksums(payload: dict[str, np.ndarray]) -> dict[str, int]:
    """Per-key CRC map ``atomic_savez`` embeds as ``meta["payload_crc"]``."""
    return {key: checksum_array(arr) for key, arr in payload.items()}


def verify_snapshot(path: str) -> dict:
    """Checksum every payload array of an ``atomic_savez`` file.

    Returns ``{"ok", "checked", "unchecked", "bad_keys", "error"}``.
    ``ok`` is False when the file is unreadable/unparsable or any
    checksummed array fails; arrays written before the ``payload_crc``
    map existed count as ``unchecked`` (and cannot fail).
    """
    report = {
        "ok": True,
        "checked": 0,
        "unchecked": 0,
        "bad_keys": [],
        "error": None,
    }
    try:
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            crcs = meta.get("payload_crc") or {}
            for key in data.files:
                if key == "meta":
                    continue
                want = crcs.get(key)
                if want is None:
                    report["unchecked"] += 1
                    continue
                report["checked"] += 1
                if checksum_array(data[key]) != int(want):
                    report["bad_keys"].append(key)
    except Exception as e:  # unreadable zip, truncated file, bad json
        report["ok"] = False
        report["error"] = repr(e)
        return report
    report["ok"] = not report["bad_keys"]
    return report


def scrub_store(store) -> dict:
    """Verify one store's summaries and their tree leaf rows in memory.

    Returns ``{"partitions", "checked", "corrupt": [pid, ...]}`` where a
    pid is corrupt when its summary bytes no longer match the CRC
    recorded at summarize time, or its arena leaf row (a write-once copy
    of those bytes) no longer matches the summary.
    """
    corrupt: list[int] = []
    checked = 0
    with store._lock:
        tree = store._tree
        for pid, s in sorted(store.summaries.items()):
            if s.crc is None:  # pre-CRC summary (legacy load): unverifiable
                continue
            checked += 1
            if checksum_array(s.boundaries, s.sizes) != s.crc:
                corrupt.append(pid)
                continue
            node = None
            if tree.base is not None and 0 <= pid - tree.base < tree.capacity:
                node = tree.nodes.get((0, pid - tree.base))
            if node is not None and not (
                np.array_equal(
                    np.asarray(node.boundaries),
                    np.asarray(s.boundaries, np.float32),
                )
                and np.array_equal(
                    np.asarray(node.sizes), np.asarray(s.sizes, np.float32)
                )
            ):
                corrupt.append(pid)  # arena plane drifted from the summary
        return {
            "partitions": len(store.summaries),
            "checked": checked,
            "corrupt": corrupt,
        }


def _wal_records_for(reg, tenant: str, pids: set[int]) -> dict[int, np.ndarray]:
    """Raw values still recoverable from the registry's WAL for ``pids``
    (re-scanned from disk — the in-memory recovered list only holds what
    existed at open time).  Last append wins for duplicate pids."""
    wal = getattr(reg, "_wal", None)
    if wal is None:
        return {}
    out: dict[int, np.ndarray] = {}
    for _path, _first, records, _torn, _epoch in wal._scan():
        for rec in records:
            if rec.tenant is not None and str(rec.tenant) == tenant:
                if rec.pid in pids:
                    out[rec.pid] = rec.values
    return out


def scrub_registry(reg, *, repair: bool = False) -> dict:
    """Scrub every tenant; with ``repair=True`` route corrupted tenants
    through WAL-replay rebuild (module docstring).

    Returns ``{"tenants", "checked", "corrupt": {name: [pids]},
    "repaired": {name: [pids]}, "dropped": {name: [pids]}}`` — repaired
    pids were re-summarized from WAL records, dropped ones had no
    surviving record (their windows degrade honestly under
    ``strict=False`` serving).
    """
    with reg._lock:
        names = sorted(reg._stores)
    out = {
        "tenants": len(names),
        "checked": 0,
        "corrupt": {},
        "repaired": {},
        "dropped": {},
    }
    for name in names:
        store = reg[name]
        rep = scrub_store(store)
        out["checked"] += rep["checked"]
        if not rep["corrupt"]:
            continue
        bad = rep["corrupt"]
        out["corrupt"][name] = list(bad)
        if not repair:
            continue
        salvaged = _wal_records_for(reg, name, set(bad))
        with store._lock:
            # drop the corrupted partitions and rebuild the tree from the
            # verified survivors — one version bump, so no cached answer
            # computed over corrupt rows can be served afterwards
            for pid in bad:
                store.summaries.pop(pid, None)
            store.rebuild_tree()
        if salvaged:
            store._apply(store._summarize_batch(salvaged))
            out["repaired"][name] = sorted(salvaged)
        lost = sorted(set(bad) - set(salvaged))
        if lost:
            out["dropped"][name] = lost
    reg.last_scrub = out
    return out


def _summary_crcs(reg) -> dict[str, dict[int, int]]:
    """``{tenant: {pid: crc}}`` snapshot of one registry, recomputed from
    the live summary bits (so in-memory rot on either side shows up as a
    divergence, not just a replication bug)."""
    with reg._lock:
        names = sorted(reg._stores)
    out: dict[str, dict[int, int]] = {}
    for name in names:
        store = reg[name]
        with store._lock:
            out[name] = {
                pid: checksum_array(s.boundaries, s.sizes)
                for pid, s in store.summaries.items()
            }
    return out


def scrub_divergence(primary, follower) -> dict:
    """Cross-check a follower registry's summaries against its primary's.

    Returns ``{"tenants", "checked", "diverged": {name: [pids]},
    "behind": {name: [pids]}, "extra": {name: [pids]}, "ok"}``:

    * ``diverged`` — partitions both sides hold whose summary CRCs
      differ.  Replication ships raw WAL records and summarization is
      bit-deterministic, so any mismatch means corruption (in flight, on
      the follower's disk, or in either heap) — never a rounding story.
    * ``behind`` — partitions the primary holds that the follower hasn't
      applied yet: replication lag, resolved by the next ``tail()``.
    * ``extra`` — partitions only the follower holds.  Normally empty;
      after a retention sweep on the primary it is the eviction lag
      mirror of ``behind``.

    ``ok`` is True iff ``diverged`` is empty — lag alone never fails the
    scrub (the staleness SLO owns that judgement).
    """
    p, f = _summary_crcs(primary), _summary_crcs(follower)
    diverged: dict[str, list[int]] = {}
    behind: dict[str, list[int]] = {}
    extra: dict[str, list[int]] = {}
    checked = 0
    for name in sorted(set(p) | set(f)):
        pc, fc = p.get(name, {}), f.get(name, {})
        bad = sorted(pid for pid in pc.keys() & fc.keys() if pc[pid] != fc[pid])
        lag = sorted(pc.keys() - fc.keys())
        ahead = sorted(fc.keys() - pc.keys())
        checked += len(pc.keys() & fc.keys())
        if bad:
            diverged[name] = bad
        if lag:
            behind[name] = lag
        if ahead:
            extra[name] = ahead
    return {
        "tenants": len(set(p) | set(f)),
        "checked": checked,
        "diverged": diverged,
        "behind": behind,
        "extra": extra,
        "ok": not diverged,
    }
