"""HistogramStore — the paper's Summarizer/Merger processing framework.

PyTorch port of ``repro.core.stream``: the same store, consistency model,
WAL and on-disk formats (an npz or WAL segment written by either package
loads in the other).  The store's device (``device=None`` → ``"cuda"``)
runs the Summarizer's row sort and every merge through the port's CUDA
kernels; ``device="cpu"`` runs their plain PyTorch versions.  Partitions
are narrowed from 64 to 32 bits *before* padding (the reference narrows
after, which wraps an int64 pad sentinel to -1 — see ``_summarize_batch``).

The paper's deployment (§5, Fig. 13): every new partition (a day of logs) is
summarized *once, offline* into a T-bucket exact histogram stored next to the
data; any time-interval query is answered *on demand* by merging the stored
summaries, never re-touching raw data.

This module is the host-side control plane of that framework:

  * ``HistogramStore.ingest(partition_id, values)``  — the Summarizer job
  * ``HistogramStore.query(lo, hi, beta)``           — the Merger job
  * npz persistence                                   — the HDFS summary files

The Merger runs on a **segment-tree interval engine** by default
(``core/interval_tree.py``): internal tree nodes hold pre-merged summaries,
so a query merges ``O(log W)`` node summaries instead of re-merging the whole
``O(W)`` window flat, answers are LRU-cached per store version, and
``query_many`` serves a whole batch of concurrent interval queries with one
static-shape batched merge kernel launch.  ``engine="flat"`` keeps the paper-literal path
(and its tighter single-level bound) for comparison and benchmarks.

The Summarizer is **shape-stable and batched**: partitions are padded with a
+inf sentinel to power-of-two length buckets and summarized through the
mask-aware ``build_exact_padded`` (bit-identical to the per-length exact
build), so any mix of partition lengths launches O(log max_n) distinct sort shapes
instead of one per distinct length, and ``ingest_many`` groups partitions by
padded shape and summarizes each group with **one row sort launch**.

Async ingest consistency model
------------------------------
With ``async_ingest=True`` (or via ``ingest_async``) partitions are pushed
onto a bounded queue and a background maintenance thread drains it in
batches: each drained batch is summarized with the grouped one-dispatch
summarizer, then applied to the store — leaves written and the tree's
ancestor paths refreshed with *one* level-batched pull-up per flush — under
the store lock, bumping the version once per batch.  Guarantees:

  * **Snapshot consistency** — queries take the same lock as batch
    application, so every answer reflects a complete set of applied
    batches (never a half-applied batch), with ``eps`` computed from
    exactly that snapshot's tree; the version key makes cached answers
    equally consistent.
  * **Prefix visibility** — batches are drained FIFO, so the visible
    partition set is always a prefix of the enqueue order.
  * **Explicit freshness** — ``flush()`` blocks until everything enqueued
    so far is visible (and re-raises any background summarization error);
    ``close()`` stops the worker after a final drain.  Nothing is
    timing-dependent: synchronization is by lock/condition only.
  * **Retention between flushes** — with a ``retention`` policy
    (core/retention.py) the watermark-driven sweeper runs on the ingest
    worker after each applied batch and *before* the pending count drops,
    so ``flush()`` returning also implies retention has been enforced on
    everything visible (synchronous ingest sweeps inline after each
    apply).  Eviction bumps the store version, so answers cached before
    an eviction can never be served after it.

The drain/poison-isolation/flush/close machinery itself is the shared
:class:`~repro_torch.core.workers.IngestPool` — one lock-sensitive
implementation for this store's single worker and the multi-tenant
registry's pool alike.

Durable ingest (``wal_dir=...``)
--------------------------------
The queue above is in-memory: without a log, a crash between ``ingest``
and ``save`` silently loses acked partitions.  With ``wal_dir`` every
ingest — sync or async — appends a checksummed record to a segmented
write-ahead log and fsyncs (group commit) **before the call returns**;
``save`` captures the log's applied watermark, persists it, and
truncates fully-covered segments; ``load(path, wal_dir=...)`` /
``recover(path, wal_dir, ...)`` replay the uncovered suffix with
idempotent pid dedup reconciled against the retention watermark.  Record
layout, fsync-batching policy, truncation-on-save invariant, and the
idempotent-replay contract are documented in core/workers.py.

Watermark persistence format
----------------------------
Retention ages partitions against the **watermark** — the highest
partition id ever ingested (ids are the time axis; see
core/retention.py).  It is persisted as the ``"watermark"`` key of the
:meth:`HistogramStore._state` meta dict (json int, or null for an empty
store) next to ``"ids"``/``"n"``/``"tree"``, and restored by
:meth:`_restore` (falling back to ``max(ids)`` for summary files written
before this key existed).  The retention policy itself round-trips
through ``save``/``load`` as the json spec ``meta["retention"]``
(``RetentionPolicy.spec()`` / ``policy_from_spec``), so a reloaded store
resumes aging exactly where it stopped instead of resurrecting expired
partitions — the registry's one-npz container persists both per tenant
the same way.

It is deliberately NumPy/host-resident (like the NameNode metadata path);
the heavy lifting — the per-partition sort and the merges — runs in the
port's kernels on the store's device.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.histogram import (
    Histogram,
    build_exact,
    build_exact_padded_batched,
    merge_list,
    next_pow2,
    pad_sentinel,
    quantile,
    theoretical_eps_max,
)
from repro_torch.analysis.witness import OrderedRLock
from repro_torch.device import resolve_device
from repro_torch.core import failpoints as faults
from repro_torch.core import pinned, spans
from repro_torch.core.arena import NodeArena
from repro_torch.core.interval_tree import COLLAPSE_MODES, IntervalTree
from repro_torch.core.retention import RetentionPolicy, StoreStats, policy_from_spec
from repro_torch.core.scrub import checksum_array, payload_checksums
from repro_torch.core.workers import IngestPool, PoolStateView, WriteAheadLog

__all__ = ["StoredSummary", "HistogramStore", "atomic_savez"]


# 64-bit partitions are summarized in 32 bits, as the reference's
# ``jnp.asarray`` (x64 off) stores them
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _narrowed(v: np.ndarray) -> np.ndarray:
    to = _NARROW.get(v.dtype)
    if to is None:
        return v
    out = v.astype(to)
    spans.count("ingest.host_copy_bytes", out.nbytes)
    return out


def _staged(v: np.ndarray, dtype) -> np.ndarray:
    """``v`` in ``dtype`` and contiguous, as a copy into the sort's buffer
    takes it; a host copy only where one of the two is missing, counted."""
    if v.dtype == dtype and v.flags.c_contiguous:
        return v
    out = np.ascontiguousarray(v, dtype=dtype)
    spans.count("ingest.host_copy_bytes", out.nbytes)
    return out


def _validated(values) -> np.ndarray:
    """Flatten + reject empty — the synchronous ingest validation rule."""
    v = np.asarray(values).reshape(-1)
    if v.shape[0] < 1:
        raise ValueError("cannot summarize an empty partition")
    return v


def atomic_savez(path: str, meta: dict, payload: dict[str, np.ndarray]) -> None:
    """Crash-safe npz write: mkstemp + fd write + fsync + atomic rename.

    Writing through the open fd keeps np.savez from appending its implicit
    ``.npz`` suffix (no stray twin files); the rename makes readers see
    either the old file or the complete new one.  Two fsyncs make that
    hold across power loss, not just process death: the temp file's fd is
    fsynced *before* ``os.replace`` (otherwise the rename can land while
    the data blocks are still dirty, leaving a zero-length "atomically
    saved" file), and the containing directory's fd is fsynced *after*
    (otherwise the rename itself may not be durable and the file simply
    vanishes).  Shared by ``HistogramStore.save`` and the multi-tenant
    registry's one-file-for-all-tenants save (core/tenant.py).

    Every payload array's CRC32 is embedded as ``meta["payload_crc"]``
    so the integrity scrubber (core/scrub.py) can prove a snapshot is
    still the bytes that were written — atomicity protects against torn
    writes, the checksums against the bit-rot that atomicity can't see.
    """
    faults.hit("snapshot.save", path=path)
    meta = {**meta, "payload_crc": payload_checksums(payload)}
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=json.dumps(meta), **payload)
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename
        rot = faults.hit("snapshot.save.corrupt", path=path)
        if rot is not None:  # injected bit-rot that survives the rename
            with open(tmp, "r+b") as f:
                f.seek(int(rot))
                f.write(b"\xde\xad\xbe\xef")
        os.replace(tmp, path)
        dfd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(dfd)  # the rename durable too
        finally:
            os.close(dfd)
    except BaseException as exc:
        try:
            os.unlink(tmp)
        except OSError as cleanup:
            exc.add_note(f"temporary snapshot {tmp} left behind: {cleanup!r}")
        raise


class _PrefixedArrays:
    """Key-prefixing view over an npz/dict — lets ``IntervalTree.from_state``
    read its ``tb_*``/``ts_*`` arrays out of a namespaced container."""

    def __init__(self, data, prefix: str):
        self._data = data
        self._prefix = prefix

    def __getitem__(self, key: str):
        return self._data[self._prefix + key]


class _VersionedDict(dict):
    """``summaries`` dict that counts its own mutations.

    The documented summary-loss idiom mutates the dict directly
    (``del store.summaries[pid]``, row replacement), which is why every
    query used to re-scan its whole interval for tree/dict desync.  The
    mutation counter turns that into an O(1) staleness token: the scan
    (and the sorted-ids cache below) re-runs only when the counter moved
    since it last verified — zero per-query cost on the hot serving path.
    Mutating through ``dict.__setitem__`` directly on the instance is the
    one way around the counter, and is out of contract.
    """

    __slots__ = ("mutations",)

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.mutations = 0

    def __setitem__(self, key, value):
        self.mutations += 1
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self.mutations += 1
        super().__delitem__(key)

    def update(self, *a, **k):
        self.mutations += 1
        super().update(*a, **k)

    def pop(self, *a):
        self.mutations += 1
        return super().pop(*a)

    def popitem(self):
        self.mutations += 1
        return super().popitem()

    def clear(self):
        self.mutations += 1
        super().clear()

    def setdefault(self, key, default=None):
        self.mutations += 1
        return super().setdefault(key, default)

# Max rows per batched-summarizer dispatch.  Chunking the batch axis keeps
# the power-of-two row padding waste ≤ ~12 % on large groups (padding 579
# rows straight to 1024 would nearly double the sort work) while the set of
# compiled shapes stays O(log k · log max_n).
_BATCH_ROWS = 256


@dataclass(frozen=True)
class StoredSummary:
    """One partition's summary — a row of the paper's summary file.

    ``crc`` is the CRC32 of the summary arrays at summarize time — the
    in-memory integrity baseline the scrubber (core/scrub.py) verifies
    rows and arena planes against.  ``None`` marks a summary injected
    through a legacy path that never checksummed (unverifiable, not
    corrupt).
    """

    partition_id: int
    n: int
    boundaries: np.ndarray
    sizes: np.ndarray
    crc: int | None = None

    def to_histogram(self, device=None) -> Histogram:
        """This summary as tensors on ``device`` (``None`` → the card)."""
        device = resolve_device(device)
        return Histogram(
            boundaries=torch.tensor(self.boundaries, device=device),
            sizes=torch.tensor(self.sizes, device=device),
        )


def _make_summary(pid: int, n: int, boundaries, sizes) -> StoredSummary:
    """StoredSummary with its integrity CRC stamped over the exact arrays
    being stored (scrub_store recomputes over the same attributes)."""
    return StoredSummary(
        partition_id=int(pid),
        n=int(n),
        boundaries=boundaries,
        sizes=sizes,
        crc=checksum_array(boundaries, sizes),
    )


@dataclass
class HistogramStore(PoolStateView):
    """Store of per-partition exact equi-depth summaries (append-only by
    default; a ``retention`` policy bounds it for infinite streams)."""

    num_buckets: int  # T — summary resolution; pick T ≥ 40·β for ≤5 % error
    summaries: dict[int, StoredSummary] = field(default_factory=dict)
    engine: str = "tree"  # default Merger path: "tree" | "flat"
    # internal-node resolution: None → T uniform; an int → that resolution
    # uniform; "geometric" → T·2^level per level (depth-independent ε bound)
    T_node: int | str | None = None
    cache_size: int = 128  # LRU capacity of the tree's answer cache
    async_ingest: bool = False  # route ``ingest`` through the background queue
    queue_size: int = 1024  # bound of the pending-partition queue
    # retention policy (core/retention.py): None → append-only (unbounded)
    retention: RetentionPolicy | None = None
    # eviction collapse policy: "canonical" keeps post-eviction trees
    # bit-identical to a fresh build over the survivors; "amortized" defers
    # the re-root behind a dead-prefix slack — O(log W) amortized merge
    # work per ingest for high-frequency sliding windows, answers still
    # within eps_total (IntervalTree._collapse documents the trade)
    collapse: str = "canonical"
    # pooled node storage (core/arena.py): None → the tree owns its own
    # arena; a TenantRegistry(shared_arena=True) passes one shared arena
    # to every tenant so cross-tenant packs become a single device gather
    arena: NodeArena | None = None
    # durable ingest (core/workers.py WriteAheadLog): a directory path
    # makes every ingest — sync or async — append + fsync a log record
    # before it acks, so an acked partition survives a crash between
    # ingest and save.  ``save`` truncates log segments covered by the
    # snapshot; ``load(path, wal_dir=...)`` / ``recover`` replay the
    # uncovered suffix with idempotent pid dedup.  The constructor never
    # replays leftover segments itself (replay needs the snapshot's
    # summaries/watermark as its dedup baseline) — use ``recover``.
    wal_dir: str | None = None
    # where the Summarizer sort and the merges run: None → "cuda" (raises
    # without a card), "cpu" → the kernels' plain versions.  A shared
    # ``arena`` brings its own device.
    device: str | torch.device | None = None
    _tree: IntervalTree = field(init=False, repr=False, default=None)

    def __post_init__(self) -> None:
        self.device = (
            self.arena.torch_device
            if self.arena is not None
            else resolve_device(self.device)
        )
        if isinstance(self.T_node, str) and self.T_node != "geometric":
            raise ValueError(f"unknown T_node mode: {self.T_node!r}")
        if self.collapse not in COLLAPSE_MODES:
            raise ValueError(f"unknown collapse mode: {self.collapse!r}")
        geometric = self.T_node == "geometric"
        self._tree = IntervalTree(
            self.num_buckets
            if (self.T_node is None or geometric)
            else self.T_node,
            cache_size=self.cache_size,
            geometric=geometric,
            arena=self.arena,
            collapse=self.collapse,
            device=self.device,
        )
        # distinct (k_pad, n_pad, T) summarizer dispatch shapes seen so far —
        # observability for the compile-stability tests and benchmarks
        self.summarize_shapes: set[tuple[int, int, int]] = set()
        # guards summaries + tree + queries.  Standalone stores carry no
        # key; TenantRegistry.tenant() keys the lock by tenant name so the
        # witness can check the sorted multi-store acquisition contract
        self._lock = OrderedRLock("store._lock")
        # mutation-counted dict + staleness tokens: queries verify
        # tree/dict sync once per (dict mutation, tree version) state
        # instead of re-scanning their interval every time (_sync_tree)
        self.summaries = _VersionedDict(self.summaries)
        self._sync_token: tuple[int, int] | None = None
        self._ids_cache: tuple[int, np.ndarray] | None = None
        # highest partition id ever ingested — the retention watermark
        # (persisted; survives the eviction of the partitions beneath it)
        self._watermark: int | None = (
            max(self.summaries) if self.summaries else None
        )
        # stats of the last WAL replay (recover/load), None until then
        self.last_recovery: dict | None = None
        # durable-ingest log (None → in-memory-only queue, the historical
        # contract); single-store records carry no tenant route
        self._wal: WriteAheadLog | None = (
            WriteAheadLog(self.wal_dir) if self.wal_dir is not None else None
        )
        # the background ingest plane: shared drain/poison-isolation/flush
        # machinery (core/workers.py); threads start lazily on first enqueue.
        # on_batch_end runs the retention sweeper on the worker between
        # flushes, before the pending count drops.
        self._pool = IngestPool(
            apply_batch=self._apply_worker_batch,
            wrap_error=self._wrap_async_error,
            workers=1,
            queue_size=self.queue_size,
            name="histstore-ingest",
            on_batch_end=self._sweep_after_batch,
            wal=self._wal,
            wal_record=lambda item: (None, item[0], item[1]),
        )
        for pid, s in self.summaries.items():
            self._tree.set_leaf(pid, s.boundaries, s.sizes)

    # (PoolStateView provides _cv/_pending/_ingest_mutex onto the pool)
    @property
    def _async_errors(self) -> list:
        """Every failed partition since the last flush: [(pid, exception)];
        a ``(None, exception)`` entry is a failed retention sweep."""
        return self._pool.errors

    @_async_errors.setter
    def _async_errors(self, value: list) -> None:
        self._pool.errors = value

    @property
    def version(self) -> int:
        """Bumps on every mutation — keys the interval engine's LRU cache."""
        return self._tree.version

    @property
    def watermark(self) -> int | None:
        """Highest partition id ever ingested (monotonic; drives TTL)."""
        return self._watermark

    # ----------------------------------------------------------- Summarizer
    def _summarize_batch(self, parts: dict[int, np.ndarray]) -> dict[int, StoredSummary]:
        """Summarize many partitions with O(#shape buckets) dispatches.

        Partitions are grouped by power-of-two padded length and each group
        is summarized by ONE ``build_exact_padded_batched`` call — one row
        sort kernel launch on the store's device (its batch axis padded to
        a power of two as well).  The padded input is built on the device:
        a buffer filled with the sentinel, each row's real values copied
        into its head straight from the caller's array (a large row on a
        CUDA device through the pinned staging ring of
        :mod:`~repro_torch.core.pinned`), the duplicated rows copied from
        the last real one.  Results reach host NumPy
        before this returns and are bit-identical to the per-partition
        ``build_exact`` path.

        64-bit partitions are narrowed to 32 bits *before* padding.  The
        reference pads first, so an int64 partition's ``iinfo(int64).max``
        sentinel wraps to -1 in ``jnp.asarray`` and sorts first: its
        ``HistogramStore(num_buckets=4).ingest(0, np.arange(100)[::-1])``
        stores ``[-1, -1, 22, 47, 71]`` where ``build_exact`` gives
        ``[0, 25, 50, 75, 99]``.  The port stores the latter.
        """
        out: dict[int, StoredSummary] = {}
        small: list[tuple[int, np.ndarray]] = []
        groups: dict[int, list[tuple[int, np.ndarray]]] = {}
        with spans.span("store.pad"):
            for pid, values in parts.items():
                v = _narrowed(np.asarray(values).reshape(-1))
                if v.shape[0] < 1:
                    raise ValueError("cannot summarize an empty partition")
                if v.shape[0] < self.num_buckets:
                    # tiny partition: summarized exactly at T = n (legacy rule)
                    small.append((int(pid), v))
                else:
                    groups.setdefault(next_pow2(v.shape[0]), []).append((int(pid), v))
        for pid, v in small:
            h = build_exact(pinned.host_tensor(_staged(v, v.dtype)).to(self.device), v.shape[0])
            out[pid] = _make_summary(
                pid, v.shape[0], h.boundaries.cpu().numpy(), h.sizes.cpu().numpy()
            )
        for n_pad, all_rows in sorted(groups.items()):
            for at in range(0, len(all_rows), _BATCH_ROWS):
                rows = all_rows[at : at + _BATCH_ROWS]
                k = len(rows)
                k_pad = next_pow2(k)
                with spans.span("store.pad"):
                    # rows of different dtypes take their common dtype,
                    # narrowed like a single partition's (np.stack's rule)
                    common = np.result_type(*(v.dtype for _, v in rows))
                    dtype = np.dtype(_NARROW.get(common, common))
                    x = torch.full(
                        (k_pad, n_pad), pad_sentinel(dtype),
                        dtype=torch.from_numpy(np.empty(0, dtype)).dtype, device=self.device,
                    )
                    # the sentinels and the duplicated rows are padding
                    spans.count(
                        "ingest.padded_values",
                        sum(n_pad - v.shape[0] for _, v in rows) + (k_pad - k) * n_pad,
                    )
                with spans.span("store.h2d"), pinned.Upload() as up:
                    for r, (_, v) in enumerate(rows):
                        if v.dtype != dtype:  # np.stack's cast, then narrowing
                            v = _narrowed(_staged(v, common))
                        v = _staged(v, dtype)
                        up.copy(x[r, : v.shape[0]], v)
                        spans.count("ingest.upload_bytes", v.nbytes)
                with spans.span("store.stack"):
                    if k < k_pad:
                        x[k:] = x[k - 1]
                    ns = np.asarray(
                        [v.shape[0] for _, v in rows] + [rows[-1][1].shape[0]] * (k_pad - k),
                        np.int32,
                    )
                self.summarize_shapes.add((k_pad, n_pad, self.num_buckets))
                with spans.span("store.sort"):
                    h = build_exact_padded_batched(x, ns, self.num_buckets)
                with spans.span("store.d2h"):
                    bs, ss = h.boundaries.cpu().numpy(), h.sizes.cpu().numpy()
                for row, (pid, v) in enumerate(rows):
                    out[pid] = _make_summary(pid, v.shape[0], bs[row], ss[row])
        return out

    def _summarize(self, partition_id: int, values) -> StoredSummary:
        pid = int(partition_id)
        return self._summarize_batch({pid: values})[pid]

    def ingest(self, partition_id: int, values) -> StoredSummary | None:
        """Summarize one new partition (the scheduled Summarizer job).

        With ``async_ingest=True`` the partition is enqueued for the
        background worker instead and ``None`` is returned — call
        :meth:`flush` for visibility.
        """
        if self.async_ingest:
            self.ingest_async(partition_id, values)
            return None
        with spans.span("store.ingest"):
            with spans.span("store.validate"):
                v = _validated(values)
            lsns = self._wal_log_sync({int(partition_id): v})
            summ = self._summarize(partition_id, v)
            self._put(summ)
            if self._wal is not None:
                self._wal.mark_applied(lsns)
            return summ

    def ingest_summary(self, partition_id: int, hist: Histogram) -> None:
        """Store an externally-built summary (e.g. one built by another
        store) — the framework does not care who summarized."""
        b, s = (
            x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (hist.boundaries, hist.sizes)
        )
        self._put(_make_summary(int(partition_id), int(s.sum()), b, s))

    def ingest_many(self, partitions: dict[int, "np.ndarray"]) -> None:
        """Bulk-summarize many partitions — grouped one-dispatch summaries
        plus a single level-batched tree maintenance pass (``log W`` merge
        dispatches total) instead of per-partition work.

        With ``async_ingest=True`` the batch is *enqueued* (input-validated
        synchronously, like :meth:`ingest_async` — and all-or-nothing, so a
        bad partition fails the call before anything is enqueued) instead
        of applied in-line, preserving FIFO prefix visibility with respect
        to every other enqueued partition — a synchronous bulk apply here
        could make later partitions visible before earlier queued ones.
        The worker drains the whole batch into one grouped summarization;
        call :meth:`flush` for visibility.
        """
        if self.async_ingest:
            validated = {
                int(pid): _validated(values) for pid, values in partitions.items()
            }
            for pid, v in validated.items():
                self._enqueue(pid, v)
            return
        with spans.span("store.ingest"):
            with spans.span("store.validate"):
                validated = {
                    int(pid): _validated(values)
                    for pid, values in partitions.items()
                }
            # sync durable path: the whole batch is appended with ONE group-
            # commit fsync (the WAL's fsync-batching policy), then applied
            lsns = self._wal_log_sync(validated)
            self._apply(self._summarize_batch(validated))
            if self._wal is not None:
                self._wal.mark_applied(lsns)
            self._maybe_sweep()

    def _put(self, summ: StoredSummary) -> None:
        self._apply({summ.partition_id: summ})
        self._maybe_sweep()

    def _apply(self, summs: dict[int, StoredSummary]) -> None:
        """Make a batch of summaries visible atomically (one version bump)."""
        if not summs:
            return
        with spans.span("store.tree_update"), self._lock:
            self.summaries.update(summs)
            newest = max(summs)
            if self._watermark is None or newest > self._watermark:
                self._watermark = newest
            self._tree.set_leaves(
                {pid: (s.boundaries, s.sizes) for pid, s in summs.items()}
            )

    def _apply_deferred(self, summs: dict[int, StoredSummary]):
        """:meth:`_apply` minus the pull-up and version bump: write the
        summaries + leaf rows now, return ``(tree, dirty_slots)`` so the
        registry's shared-arena batched apply can pull up *all* touched
        trees with one merge dispatch per level and invalidate each once.
        Caller holds ``_lock`` (and keeps holding it through the pull-up);
        ``dirty_slots`` is ``None`` when a below-base id forced an inline
        rebuild (that path already left the tree consistent).
        """
        self.summaries.update(summs)
        newest = max(summs)
        if self._watermark is None or newest > self._watermark:
            self._watermark = newest
        dirty = self._tree._write_leaves(
            {pid: (s.boundaries, s.sizes) for pid, s in summs.items()}
        )
        return self._tree, dirty

    def rebuild_tree(self) -> None:
        with self._lock:
            self._tree.rebuild(
                {p: (s.boundaries, s.sizes) for p, s in self.summaries.items()}
            )

    # ------------------------------------------------------------ retention
    def evict(self, partition_ids: Iterable[int]) -> list[int]:
        """Drop partitions from the store: summaries and tree leaves leave
        together (``set_leaf``'s pull-up in reverse, with lazy subtree
        collapse), with one version bump — cached answers from before the
        eviction can never be served after it.  Returns the partition ids
        actually evicted (absent ids are ignored).  The watermark does NOT
        move: evicted history stays expired after a save/load round-trip.
        """
        with self._lock:
            victims = sorted(
                {int(p) for p in partition_ids} & self.summaries.keys()
            )
            if not victims:
                return []
            for pid in victims:
                del self.summaries[pid]
            self._tree.evict_leaves(victims)
            return victims

    def sweep_retention(self) -> list[int]:
        """Evaluate the retention policy against the watermark and evict
        its victims; re-evaluates until the policy is satisfied (so
        ``MemoryBudget`` converges over its estimate-driven passes).
        Returns everything evicted.  No-op without a policy.
        """
        if self.retention is None:
            return []
        evicted: list[int] = []
        with spans.span("store.retention"), self._lock:
            while True:
                victims = self.evict(
                    self.retention.victims(self._retention_stats())
                )
                if not victims:
                    return evicted
                evicted += victims

    def _retention_stats(self) -> StoreStats:
        """Policy-facing snapshot (callers hold ``_lock``)."""
        ids = tuple(sorted(self.summaries))
        wm = self._watermark
        if wm is None and ids:
            wm = ids[-1]  # summaries injected without _apply (rare)
        return StoreStats(
            ids=ids, watermark=wm, node_floats=self._tree.node_floats()
        )

    def _maybe_sweep(self) -> None:
        if self.retention is not None:
            self.sweep_retention()

    def _sweep_after_batch(self, batch) -> None:
        """Retention slot of the ingest worker (IngestPool on_batch_end):
        runs between flushes, before the pending count drops."""
        self._maybe_sweep()

    def node_floats(self) -> int:
        """Current tree node-float footprint (shared arrays counted once)
        — the figure retention budgets act on."""
        with self._lock:
            return self._tree.node_floats()

    # -------------------------------------------------------- async ingest
    def ingest_async(self, partition_id: int, values) -> None:
        """Enqueue a partition for the background Summarizer.

        Non-blocking unless the bounded queue is full.  The partition
        becomes visible when the worker's next flush applies it; call
        :meth:`flush` to wait for (and surface errors from) everything
        enqueued so far.  Input validation happens here, synchronously, so
        an obviously-bad partition fails the caller instead of the queue.
        """
        self._enqueue(int(partition_id), _validated(values))

    def _enqueue(self, pid: int, values: np.ndarray) -> None:
        """Post-validation enqueue body shared with async ``ingest_many``.
        With a WAL the pool appends + fsyncs the record before returning."""
        self._pool.submit((pid, values))

    # ------------------------------------------------------------ WAL plane
    def _wal_log_sync(self, parts: dict[int, np.ndarray]) -> list[int]:
        """Append a synchronous-ingest batch to the WAL with one group-
        commit fsync; returns the LSNs to ``mark_applied`` after the
        apply.  No-op (empty list) without a WAL."""
        if self._wal is None or not parts:
            return []
        with spans.span("store.wal"):
            lsns = [self._wal.append(None, pid, v) for pid, v in parts.items()]
            self._wal.commit(lsns[-1])
        return lsns

    def wal_stats(self) -> dict | None:
        """WAL depth / fsync-latency / footprint counters (telemetry),
        or ``None`` when the store runs without a log."""
        return None if self._wal is None else self._wal.stats()

    def _replay_wal(self, covered_lsn: int) -> int:
        """Re-ingest the WAL suffix not covered by the loaded snapshot.

        The idempotent-replay contract (core/workers.py docstring):
        records with ``lsn <= covered_lsn`` are covered by the snapshot's
        state; above that, a pid already present was applied after the
        stable capture but still made the snapshot (skip), and a pid ≤
        the watermark was applied and later evicted by retention (skip —
        replay must not resurrect expired partitions).  Everything else
        is re-summarized and applied in one batch.  Returns the number of
        partitions replayed and records recovery stats on
        ``self.last_recovery``.
        """
        records = self._wal.recovered_records()
        fresh: dict[int, np.ndarray] = {}
        for rec in records:
            if rec.lsn <= covered_lsn:
                continue
            if rec.pid in self.summaries:
                continue
            if self._watermark is not None and rec.pid <= self._watermark:
                continue
            fresh[rec.pid] = rec.values  # duplicate pids: last append wins
        if fresh:
            self._apply(self._summarize_batch(fresh))
            self._maybe_sweep()
        # scanned records are now reflected in memory (or deliberately
        # skipped) — eligible for truncation at the next save
        self._wal.mark_applied(rec.lsn for rec in records)
        self.last_recovery = {
            "records_scanned": len(records),
            "replayed": len(fresh),
            "skipped_covered": len(records) - len(fresh),
            "torn_records_dropped": self._wal.torn_records_dropped,
        }
        return len(fresh)

    def _attach_wal(self, wal_dir: str, covered_lsn: int | None) -> None:
        """Open (or adopt) the log at ``wal_dir``, replay its uncovered
        suffix, and route future submits through it."""
        self.wal_dir = str(wal_dir)
        self._wal = WriteAheadLog(self.wal_dir)
        self._wal.ensure_position(covered_lsn)
        self._pool.wal = self._wal
        self._pool.wal_record = lambda item: (None, item[0], item[1])
        self._replay_wal(-1 if covered_lsn is None else int(covered_lsn))

    def _apply_worker_batch(self, batch: list[tuple[int, np.ndarray]]) -> None:
        """IngestPool apply callback: one grouped summarization + one
        level-batched tree maintenance pass per drained batch (also the
        per-item retry body of the pool's poison isolation)."""
        with spans.span("store.ingest"):
            self._apply(self._summarize_batch(dict(batch)))

    @staticmethod
    def _wrap_async_error(item, exc: BaseException):
        # pool error record: (pid, exception); a failed retention sweep
        # (item None — the on_batch_end hook) records as (None, exception)
        return (item[0] if item is not None else None, exc)

    def flush(self) -> None:
        """Block until every enqueued partition is summarized, visible, and
        retention-swept.

        Re-raises (wrapped) every per-partition error the background worker
        hit since the last flush; the queue keeps draining either way, so a
        poison partition never wedges it — and never takes down the valid
        partitions drained into the same batch (they are retried and
        applied individually).
        """
        errs = self._pool.drain()
        if errs:
            detail = "; ".join(
                f"partition {pid}: {e!r}"
                if pid is not None
                else f"retention sweep: {e!r}"
                for pid, e in errs
            )
            raise RuntimeError(
                f"async ingest failed for {len(errs)} partition(s): {detail}"
            ) from errs[0][1]

    def close(self) -> None:
        """Drain the queue, stop the background worker, surface errors."""
        self._pool.close()
        self.flush()

    def _present_ids(self, lo: int, hi: int) -> list[int]:
        """Present partition ids in ``[lo, hi]`` — O(log n + matches) via a
        sorted-ids cache keyed on the dict mutation counter, instead of an
        O(interval) membership scan per query (callers hold ``_lock``)."""
        summ = self.summaries
        if not isinstance(summ, _VersionedDict):  # summaries dict replaced
            return [i for i in range(lo, hi + 1) if i in summ]
        cache = self._ids_cache
        if cache is None or cache[0] != summ.mutations:
            arr = np.fromiter(summ.keys(), np.int64, len(summ))
            arr.sort()
            cache = (summ.mutations, arr)
            self._ids_cache = cache
        arr = cache[1]
        a = int(np.searchsorted(arr, lo, side="left"))
        b = int(np.searchsorted(arr, hi, side="right"))
        return arr[a:b].tolist()

    def _sync_tree(self, ids: list[int], lo: int, hi: int) -> list[tuple[int, int]]:
        """Re-sync after direct ``summaries`` dict mutation (the documented
        summary-loss idiom ``del store.summaries[pid]``, or outright row
        replacement).  Every tree leaf remembers the stored summary arrays
        it was copied from (``TreeNode.src``), and the dict counts its own
        mutations, so the pointer-identity staleness scan runs **once per
        (dict mutations, tree version) state**: the whole store is
        verified (and repaired — replaced leaves re-point level-batched,
        deletions rebuild), the token is cached, and every later query in
        the same state goes straight to the canonical decomposition —
        O(1) instead of O(interval) on the warm-miss serving path.
        Returns the (post-sync) decomposition of ``[lo, hi]`` so hot
        callers (the cross-tenant registry) don't decompose twice."""
        tree = self._tree
        summ = self.summaries
        versioned = isinstance(summ, _VersionedDict)
        if versioned:
            token = (summ.mutations, tree.version)
            if token == self._sync_token:
                return tree.decompose(lo, hi)
        items = summ.items() if versioned else [(i, summ[i]) for i in ids]
        stale = []
        for pid, s in items:
            node = None
            if tree.base is not None and 0 <= pid - tree.base < tree.capacity:
                node = tree.nodes.get((0, pid - tree.base))
            if (
                node is None
                or node.src is None
                or node.src[0] is not s.boundaries
                or node.src[1] is not s.sizes
            ):
                stale.append(pid)
        if stale:
            tree.set_leaves(
                {pid: (summ[pid].boundaries, summ[pid].sizes) for pid in stale}
            )
        if versioned:
            if tree.num_leaves() != len(summ):
                self.rebuild_tree()  # leaves were deleted from the dict
            self._sync_token = (summ.mutations, tree.version)
            return tree.decompose(lo, hi)
        sel = tree.decompose(lo, hi)
        if sum(tree.nodes[k].leaves for k in sel) != len(ids):
            self.rebuild_tree()
            sel = tree.decompose(lo, hi)
        return sel

    # --------------------------------------------------------------- Merger
    def query(
        self,
        lo: int,
        hi: int,
        beta: int,
        *,
        strict: bool = True,
        engine: str | None = None,
    ) -> tuple[Histogram, float]:
        """β-bucket histogram over partitions ``lo..hi`` (inclusive).

        Returns ``(histogram, eps_max)`` where ``eps_max`` is the guaranteed
        maximum bucket/range-size error of *this* answer: the segment-tree
        engine reports its composed per-level bound, the flat engine the
        paper's single-level ``2N/T + 2k``.  With ``strict=False`` missing
        partitions are skipped (summary-loss tolerance: a lost shard degrades
        the answer instead of failing it).  Safe under concurrent async
        ingest: the answer is a consistent whole-batch snapshot.
        """
        with self._lock:
            ids = self._present_ids(lo, hi)
            if strict and len(ids) != hi - lo + 1:
                missing = sorted(set(range(lo, hi + 1)) - set(ids))
                raise KeyError(f"missing partition summaries: {missing}")
            if not ids:
                raise KeyError("no partition summaries in requested interval")
            if (engine or self.engine) == "tree":
                self._sync_tree(ids, lo, hi)
                return self._tree.query(lo, hi, beta)
            hs = [self.summaries[i].to_histogram(self.device) for i in ids]
            merged = merge_list(hs, beta)
            merged = Histogram(
                merged.boundaries.cpu().numpy(), merged.sizes.cpu().numpy()
            )
            n = sum(self.summaries[i].n for i in ids)
            eps = theoretical_eps_max(
                n, self.num_buckets, k=len(ids), exact_inputs=False
            )
            return merged, eps

    def query_many(
        self,
        intervals: Sequence[tuple[int, int]],
        beta: int,
        *,
        strict: bool = True,
    ) -> list[tuple[Histogram | None, float]]:
        """Answer a batch of interval queries with one batched merge kernel launch.

        The serving path for many concurrent users: every query's canonical
        node set is padded to one static shape, so the whole batch costs a
        single merge launch regardless of the mix of window lengths (cached
        repeats cost none at all).  ``strict`` behaves exactly as in
        :meth:`query` (and defaults the same way): missing partitions raise
        unless ``strict=False``.  With ``strict=False`` an interval holding
        *zero* present summaries does not kill the batch (summary-loss
        tolerance): its slot in the returned list is the placeholder
        ``(None, float("inf"))`` — indexing is stable, result ``i`` always
        answers ``intervals[i]``.
        """
        with self._lock:
            results: list[tuple[Histogram | None, float]] = [None] * len(
                intervals
            )
            live: list[int] = []
            for qi, (lo, hi) in enumerate(intervals):
                ids = self._present_ids(lo, hi)
                if strict and len(ids) != hi - lo + 1:
                    missing = sorted(set(range(lo, hi + 1)) - set(ids))
                    raise KeyError(f"missing partition summaries: {missing}")
                self._sync_tree(ids, lo, hi)
                if ids:
                    live.append(qi)
                elif strict:  # degenerate strict span (hi < lo)
                    raise KeyError(
                        "no partition summaries in requested interval"
                    )
                else:
                    results[qi] = (None, float("inf"))
            answered = self._tree.query_many(
                [intervals[qi] for qi in live], beta
            )
            for qi, ans in zip(live, answered):
                results[qi] = ans
            return results

    def quantile_query(
        self, lo: int, hi: int, q, beta: int | None = None
    ) -> np.ndarray:
        """e.g. the paper's motivating '95th-percentile latency for any
        interval': ``store.quantile_query(day0, day1, 0.95)``."""
        beta = beta or min(self.num_buckets, 254)
        h, _ = self.query(lo, hi, beta, strict=False)
        return quantile(h, np.asarray(q), device=self.device).cpu().numpy()

    # ---------------------------------------------------------- persistence
    def _state(
        self, prefix: str = "", tree_slot_map=None
    ) -> tuple[dict, dict[str, np.ndarray]]:
        """(json-able meta, array payload) of summaries + tree nodes.

        Array keys are ``prefix``-namespaced so many stores can share one
        npz (the ``TenantRegistry`` container format).  With
        ``tree_slot_map`` (the registry's shared-arena save) the tree's
        node records point into pools the registry exported once for all
        tenants, and no tree arrays are emitted here.  Callers must hold
        or not need ``_lock``.
        """
        tree_meta, tree_arrays = self._tree.state(slot_map=tree_slot_map)
        meta = {
            "ids": sorted(self.summaries),
            "n": {str(p): s.n for p, s in self.summaries.items()},
            "tree": tree_meta,
            # retention watermark (module docstring: persistence format) —
            # survives eviction of everything beneath it
            "watermark": self._watermark,
        }
        payload = {}
        for pid, s in self.summaries.items():
            payload[f"{prefix}b_{pid}"] = s.boundaries
            payload[f"{prefix}s_{pid}"] = s.sizes
        for key, arr in tree_arrays.items():
            payload[f"{prefix}{key}"] = arr
        return meta, payload

    def _restore(self, meta: dict, data, prefix: str = "", tree_arrays=None) -> None:
        """Rebuild summaries + tree from a :meth:`_state`-shaped payload.

        ``tree_arrays`` overrides where the tree's pool arrays are read
        from — the registry's shared-arena container stores them once,
        outside every tenant's prefix.
        """
        wm = meta.get("watermark")
        if wm is None and meta["ids"]:  # pre-watermark summary files
            wm = max(int(p) for p in meta["ids"])
        self._watermark = None if wm is None else int(wm)
        for pid in meta["ids"]:
            b = data[f"{prefix}b_{pid}"]
            s = data[f"{prefix}s_{pid}"]
            # re-stamp the integrity CRC over the loaded bytes: the
            # snapshot's own payload_crc map was (or can be) verified by
            # the scrubber; from here on these arrays are the baseline
            self.summaries[int(pid)] = _make_summary(
                int(pid), meta.get("n", {}).get(str(pid), s.sum()), b, s
            )
        if "tree" in meta:  # restore pre-merged nodes — no re-merge on load
            self._tree = IntervalTree.from_state(
                meta["tree"],
                tree_arrays
                if tree_arrays is not None
                else _PrefixedArrays(data, prefix),
                cache_size=self.cache_size,
                arena=self.arena,  # keep shared-arena stores shared
                collapse=self.collapse,
                device=self.device,
            )
            # share leaf storage with the summary rows so _sync_tree's
            # pointer-identity staleness scan passes without re-merging
            for pid, s in self.summaries.items():
                self._tree.adopt_leaf_arrays(pid, s.boundaries, s.sizes)
        else:  # summary file from an older layout: rebuild level-batched
            self.rebuild_tree()

    def save(self, path: str) -> None:
        """Atomic write (tmpfile + fsync + rename) — summary files survive
        crashes.

        Persists the pre-merged tree nodes next to the leaf summaries (so a
        reloaded store serves interval queries without re-merging anything)
        plus the store configuration (``T_node``, ``engine``,
        ``cache_size``) so a reload reconstructs the same Merger.

        With a WAL, this is the checkpoint half of the truncation-on-save
        invariant: the log's ``stable_lsn`` is captured *before* the state
        is read (everything ≤ it was applied before the snapshot, hence
        covered), persisted as ``meta["wal_stable_lsn"]``, and — only
        after the atomic rename succeeded — every log segment fully
        covered by the snapshot is deleted.
        """
        stable = None if self._wal is None else self._wal.stable_lsn
        with self._lock:
            state_meta, payload = self._state()
            meta = {
                "num_buckets": self.num_buckets,
                "engine": self.engine,
                "T_node": self.T_node,
                "cache_size": self.cache_size,
                "retention": (
                    None if self.retention is None else self.retention.spec()
                ),
                "collapse": self.collapse,
                "wal_stable_lsn": stable,
                **state_meta,
            }
        atomic_savez(path, meta, payload)
        if self._wal is not None:
            self._wal.truncate(stable)

    @classmethod
    def load(
        cls, path: str, wal_dir: str | None = None, device=None
    ) -> "HistogramStore":
        """Restore from a summary file (written by this package or the
        reference) onto ``device``; with ``wal_dir``, also replay the log
        suffix the snapshot doesn't cover (crash-consistent restore — see
        :meth:`recover` for the missing-snapshot case)."""
        faults.hit("snapshot.load", path=path)
        # context-managed NpzFile: every array is materialized inside the
        # block, so the fd closes here instead of leaking for the store's
        # lifetime (an NpzFile holds its file handle open until closed)
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            T_node = meta.get("T_node")
            store = cls(
                num_buckets=int(meta["num_buckets"]),
                engine=str(meta.get("engine", "tree")),
                T_node=(
                    T_node if T_node in (None, "geometric") else int(T_node)
                ),
                cache_size=int(meta.get("cache_size", 128)),
                retention=policy_from_spec(meta.get("retention")),
                collapse=str(meta.get("collapse", "canonical")),
                device=device,
            )
            store._restore(meta, data)
        if wal_dir is not None:
            store._attach_wal(wal_dir, meta.get("wal_stable_lsn"))
        return store

    @classmethod
    def recover(
        cls, path: str, wal_dir: str, **store_kwargs
    ) -> "HistogramStore":
        """Crash-consistent startup: snapshot + WAL → the acked state.

        If ``path`` exists it is loaded and the WAL's uncovered suffix
        replayed on top (``load``); if the crash happened before the
        first save, the store is rebuilt from the WAL alone using
        ``store_kwargs`` as its configuration.  Either way, every acked
        ingest is present and the store keeps logging to ``wal_dir``.
        """
        if os.path.exists(path):
            return cls.load(path, wal_dir=wal_dir, device=store_kwargs.get("device"))
        store = cls(**store_kwargs)
        store._attach_wal(wal_dir, None)
        return store

    # ------------------------------------------------------------- utility
    def ids(self) -> list[int]:
        return sorted(self.summaries)

    def total_n(self, ids: Iterable[int] | None = None) -> int:
        ids = list(ids) if ids is not None else self.ids()
        return sum(self.summaries[i].n for i in ids)

    def cache_stats(self) -> dict[str, int]:
        """The tree's cache hits, misses and version, then every span
        total and counter of :mod:`~repro_torch.core.spans`: those are
        process-wide, as ``kernels._lib.LAUNCHES`` is, and cover every
        store in the process."""
        return {
            "hits": self._tree.cache_hits,
            "misses": self._tree.cache_misses,
            "version": self._tree.version,
            **spans.snapshot(),
        }
