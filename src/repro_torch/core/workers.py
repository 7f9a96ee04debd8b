"""Shared async-ingest worker pool for the store and the tenant registry.

``HistogramStore``'s single background thread and ``TenantRegistry``'s
worker pool used to be near-duplicate lock-sensitive code: the greedy
queue drain, the poison-row isolation retry, the enqueue-vs-close mutex
(a producer landing an item behind the shutdown sentinel would strand it,
leaking ``pending`` and wedging every later flush), and the
pending-count/condition bookkeeping that makes ``flush()`` deterministic.
This module is that logic, once — both planes now build an
:class:`IngestPool` with plane-specific callbacks, so fixes to the drain
loop land in one place.

Contract (the async-ingest consistency model of core/stream.py):

* ``submit(item, route)`` enqueues; items with the same route key stay
  FIFO (per-tenant prefix visibility in the registry; a single store uses
  one route).  Threads are started lazily and restarted transparently
  after ``close()``.
* Each worker drains whatever is already queued into one batch and calls
  ``apply_batch(batch)``.  If the batch raises, every item is retried
  alone — a poison item cannot take down its co-batched neighbours — and
  each individual failure is recorded as ``wrap_error(item, exc)`` under
  the pool condition (pairs with ``drain()``'s swap-read: a failure
  concurrent with a flush can neither vanish nor double-report).  The
  batch is the registry's cross-tenant unit of work: with a shared node
  arena its ``apply_batch`` pulls up every tenant touched by the drained
  batch with one merge dispatch per tree level (core/tenant.py
  ``_apply_groups_batched``), which is why workers drain greedily instead
  of applying item by item.
* ``on_batch_end(batch)``, when given, runs on the worker after every
  applied batch and *before* the pending count drops — the retention
  sweeper's slot: ``flush()`` returning implies the sweep ran on
  everything visible.  Its failures are recorded as
  ``wrap_error(None, exc)``.
* ``drain()`` blocks until everything submitted so far is processed and
  returns (swapping out) the accumulated error records; ``close()`` stops
  the workers after a final drain of each queue.  Nothing is
  timing-dependent: synchronization is by lock/condition only.

Write-ahead log: the durable-ingest contract
--------------------------------------------
The queue above is in-memory: a crash between ``submit`` and the next
flush silently loses partitions the persisted npz never saw.  With a
:class:`WriteAheadLog` attached (``IngestPool(wal=..., wal_record=...)``,
built by ``HistogramStore(wal_dir=...)`` / ``TenantRegistry(wal_dir=...)``)
every submitted partition is appended to a segmented on-disk log and
**fsynced before the submit call returns** — an acked partition can
always be replayed, so ``save``/``load`` become real checkpoint/restore
(``HistogramStore.recover`` / ``TenantRegistry.recover``).

**Record layout** (little-endian, one record per submitted partition)::

    magic  b"WAL1"                      4 bytes
    lsn    u64   log sequence number    8 bytes (monotonic, dense)
    crc32  u32   over header+payload    4 bytes
    hlen   u32   header length          4 bytes
    header utf-8 json                   hlen bytes
           {"tenant": str|null, "pid": int, "dtype": str,
            "shape": [...], "nbytes": int}
    payload raw little-endian array bytes   nbytes bytes

Records live in segment files ``wal-<first_lsn>.log``; a segment is
rotated once it exceeds ``segment_bytes`` (the outgoing segment is
fsynced at rotation, so a later group commit never needs to revisit it).
A new process always appends to a **fresh** segment — a torn tail from a
crash is never appended over.

**Epoch fencing (replication).**  Every fresh segment starts with a
12-byte header ``b"WEP1" + epoch u64`` stamping the writer's epoch
(segments without the header — the pre-replication format — read as
epoch 0).  The epoch is persisted in ``epoch.json`` next to the
segments, together with an optional ``fenced_at`` mark: ``fence(e)``
persists the mark and every later ``append`` on a log whose epoch is
below it raises :class:`~repro_torch.core.resilience.PrimaryFenced` — a
follower promoted at epoch ``e`` (core/replication.py) permanently
rejects the deposed primary's late writes, even across a restart of the
deposed process.  ``segment_view()`` / ``read_segment()`` are the
shipping surface: the view reports each segment's safe-to-read byte
length (for the active segment, the flushed record-boundary position),
and a reader holding a path that ``truncate()`` deleted underneath it
gets a clean ``None`` ("segment rotated away") instead of a
FileNotFoundError masquerading as a torn tail.

**Fsync batching (group commit).** ``append`` buffers the record and
assigns its LSN; ``commit(lsn)`` returns once every append up to ``lsn``
is durable.  Concurrent committers share one ``os.fsync``: whoever takes
the commit lock first syncs *everything appended so far* and later
committers find their LSN already covered — acks are never issued before
durability, but N concurrent submits cost ~1 fsync, and batch ingest
(``ingest_many``) appends the whole batch then commits once.

**Truncation-on-save invariant.** The log tracks the contiguous
*applied* prefix (``stable_lsn``): a record is marked applied when its
batch leaves the worker (or when the synchronous ingest path applied
it).  ``save`` captures ``stable_lsn`` **before** reading the store
state — every record ≤ that LSN was applied before the snapshot was
taken, hence is covered by it — persists it as ``meta["wal_stable_lsn"]``
and, after the atomic rename succeeds, deletes every closed segment
whose records are all ≤ the captured LSN.  Log lifecycle is therefore
tied to checkpoints: the log holds exactly the suffix not yet covered by
a snapshot (plus the tail of the active segment).

**Idempotent-replay contract.** Recovery scans the segments in LSN
order, stopping at the first torn/corrupt record *of each segment* (a
torn tail is a record whose ack never returned — dropping it is
correct), then re-ingests records above the snapshot's
``wal_stable_lsn`` with **pid dedup reconciled against the persisted
watermark**: a pid already present is skipped (it was applied after the
stable capture but still made the snapshot), and a pid ≤ the tenant's
watermark is skipped (it was applied and later evicted by retention —
replay must not resurrect expired partitions).  Replay is idempotent:
recovering twice, or recovering a log whose records were all applied,
changes nothing.  Partition ids are assumed monotone per tenant
(they are the time axis), which is what makes the watermark rule sound.
A *poisoned* record (one whose apply permanently fails) is still marked
applied once its retry completes — the WAL guards against crashes, not
bad data: poison failures surface on ``flush()`` exactly once and are
not replayed forever.  ``ingest_summary`` bypasses the WAL (there are no
raw values to log); durability there remains snapshot-only.
"""
from __future__ import annotations

import binascii
import json
import os
import queue
import struct
import threading
import time
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.analysis.witness import OrderedLock, OrderedRLock
from repro_torch.core import failpoints as faults
from repro_torch.core.resilience import (
    IngestBackpressure,
    PrimaryFenced,
    RetryPolicy,
    retry_call,
)

__all__ = [
    "IngestPool",
    "PartialBatchFailure",
    "PoolStateView",
    "WalRecord",
    "WriteAheadLog",
    "atomic_write_json",
    "read_segment_epoch",
    "scan_wal_bytes",
]

_SENTINEL = object()  # shuts down one pool worker

_WAL_MAGIC = b"WAL1"
_WAL_PREFIX = struct.Struct("<4sQII")  # magic, lsn, crc32, header_len

_SEG_MAGIC = b"WEP1"
_SEG_HEADER = struct.Struct("<4sQ")  # magic, writer epoch


def read_segment_epoch(data: bytes) -> tuple[int, int]:
    """``(epoch, header_bytes)`` of a segment's byte prefix.  Segments
    written before the epoch header existed start directly with a record
    and read as epoch 0 with a 0-byte header."""
    if len(data) >= _SEG_HEADER.size:
        magic, epoch = _SEG_HEADER.unpack_from(data, 0)
        if magic == _SEG_MAGIC:
            return int(epoch), _SEG_HEADER.size
    return 0, 0


def scan_wal_bytes(data: bytes, at: int = 0) -> tuple[list["WalRecord"], int]:
    """Parse complete records from ``data[at:]``; returns ``(records,
    next_at)`` where ``next_at`` sits just past the last complete record.
    A short/torn/corrupt suffix is left unconsumed — incremental tailers
    (the replication follower) re-try from ``next_at`` once more bytes
    arrive, and recovery counts it as the segment's torn tail."""
    records: list[WalRecord] = []
    while at < len(data):
        if at + _WAL_PREFIX.size > len(data):
            break  # torn/short prefix
        magic, lsn, crc, hlen = _WAL_PREFIX.unpack_from(data, at)
        if magic != _WAL_MAGIC:
            break
        body_at = at + _WAL_PREFIX.size
        if body_at + hlen > len(data):
            break  # torn/short header
        try:
            header = json.loads(data[body_at : body_at + hlen])
            nbytes = int(header["nbytes"])
        except (ValueError, KeyError, UnicodeDecodeError):
            break
        pay_at = body_at + hlen
        if pay_at + nbytes > len(data):
            break  # torn/short payload
        blob = data[body_at : pay_at + nbytes]
        if binascii.crc32(blob) != crc:
            break  # corrupt record
        values = np.frombuffer(
            data[pay_at : pay_at + nbytes], dtype=header["dtype"]
        ).reshape(header["shape"])
        records.append(
            WalRecord(
                lsn=int(lsn),
                tenant=header["tenant"],
                pid=int(header["pid"]),
                values=np.array(values),  # writable copy
            )
        )
        at = pay_at + nbytes
    return records, at


def mass_meta_path(dir: str) -> str:
    """The WAL directory's durable cumulative-mass ledger (mass.json)."""
    return os.path.join(str(dir), "mass.json")


def atomic_write_json(path: str, obj, *, fsync: bool = True) -> None:
    """Write small JSON state durably: tmp + fsync + rename (+ dir
    fsync), so a crash leaves either the old file or the new one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


class WalRecord(NamedTuple):
    """One durably-logged partition: ``lsn`` orders it, ``tenant`` routes
    it (``None`` for a standalone store), ``pid``/``values`` replay it."""

    lsn: int
    tenant: str | None
    pid: int
    values: np.ndarray


class WriteAheadLog:
    """Segmented on-disk write-ahead log (format: module docstring).

    Thread-safe: ``append`` serializes under the log lock, ``commit`` is
    a group-commit fsync, ``mark_applied`` advances the contiguous
    applied prefix that drives truncation.  Opening a directory with
    existing segments scans them once (recovered records are kept for
    :meth:`recovered_records`) and positions the next LSN after the last
    valid record; new appends go to a fresh segment.
    """

    def __init__(
        self,
        dir: str,
        *,
        segment_bytes: int = 4 << 20,
        fsync: bool = True,
        retry: RetryPolicy | None = None,
        epoch: int | None = None,
    ):
        self.dir = str(dir)
        self.segment_bytes = int(segment_bytes)
        self.fsync_enabled = bool(fsync)
        # transient-fault policy for the group-commit fsync: a flaky disk
        # (EIO that clears, momentary ENOSPC) heals inside commit() itself;
        # a persistently sick one exhausts the budget and the failure
        # propagates to the submitter as backpressure (IngestPool.submit)
        self.retry = retry if retry is not None else RetryPolicy(
            attempts=3, base=0.005, cap=0.1
        )
        os.makedirs(self.dir, exist_ok=True)
        # rank note (ANALYSIS.md): commit() nests _commit_lock OUTER and
        # _lock inner (grab the fd/lsn snapshot under _lock, fsync outside
        # it) — so _commit_lock ranks BELOW _lock in the hierarchy
        self._lock = OrderedLock("wal._lock")  # append/rotate/bookkeeping
        self._commit_lock = OrderedLock("wal._commit_lock")  # group-commit fsync
        self._fd = None  # active segment file object (lazy)
        self._fd_broken = False  # rollback failed → rotate before next write
        self._active_path: str | None = None
        # set by close(): cuts any in-flight backoff wait short
        self._interrupt = threading.Event()
        # telemetry counters (core/telemetry.py surfaces these)
        self.appends = 0
        self.fsyncs = 0
        self.fsync_retries = 0
        self.append_rollbacks = 0
        self.fsync_seconds = 0.0
        self.last_fsync_seconds = 0.0
        self.bytes_written = 0
        self.torn_records_dropped = 0
        # epoch fencing (module docstring): the writer's epoch is stamped
        # into every fresh segment header; fence() persists a fenced_at
        # mark that permanently rejects appends from lower-epoch writers
        disk_epoch, fenced_at = self._load_epoch_state()
        self.epoch = max(disk_epoch, 0 if epoch is None else int(epoch))
        self._fence_epoch: int | None = fenced_at
        if self.epoch != disk_epoch:
            self._store_epoch_state()
        # per-tenant cumulative appended mass (value counts) — the ship
        # manifest's drift currency (core/replication.py): a follower
        # bounds its staleness by manifest mass − mass it has scanned.
        # Truncation removes record *bytes* but their mass must survive
        # a reopen, or a follower attached after a checkpoint would
        # bound its drift at 0 and silently miss the snapshot-covered
        # prefix: ``_shed_mass`` (mass.json) is the durable ledger of
        # mass truncated out of the log, and ``_mass`` = shed + in-log.
        self._shed_mass, pending = self._load_mass_state()
        self._mass: dict = {k: v for k, v in self._shed_mass.items() if v}
        self._seg_mass: dict[str, dict] = {}  # path -> per-tenant mass
        # tracked segments found missing on disk by segment_view() —
        # out-of-band deletion, always an anomaly worth surfacing
        self.vanished_segments = 0
        self.close_errors = 0
        # closed segments: path -> (first_lsn, last_valid_lsn)
        self._segments: dict[str, tuple[int, int]] = {}
        self._recovered: list[WalRecord] = []
        first = None
        last = 0
        had_pending = bool(pending)
        for path, first_lsn, records, torn, seg_epoch in self._scan():
            self._recovered.extend(records)
            self.torn_records_dropped += torn
            last_valid = records[-1].lsn if records else first_lsn - 1
            self._segments[path] = (first_lsn, last_valid)
            charged = pending.pop(os.path.basename(path), None)
            if charged is not None:
                # a truncate() crashed between charging this segment to
                # the shed ledger and unlinking it: the bytes are still
                # here (about to be counted by the scan) — un-charge
                for k, m in charged.items():
                    self._shed_mass[k] = self._shed_mass.get(k, 0) - int(m)
                    self._mass[k] = self._mass.get(k, 0) - int(m)
            seg_m = self._seg_mass.setdefault(path, {})
            for rec in records:
                key = rec.tenant
                self._mass[key] = self._mass.get(key, 0) + int(
                    rec.values.size
                )
                seg_m[key] = seg_m.get(key, 0) + int(rec.values.size)
            if first is None:
                first = first_lsn
            last = max(last, last_valid)
        if had_pending:
            # pending entries whose files are gone really were unlinked
            # (their mass stays shed); settle the ledger either way
            self._store_mass_state()
        self._next_lsn = last + 1
        self._written_lsn = last  # highest appended (durable: on disk)
        self._synced_lsn = last
        # contiguous applied prefix: everything ≤ _stable was applied
        # in-memory (→ covered by the next snapshot).  Records found on
        # disk start *unapplied*; replay marks them.
        self._stable = (first - 1) if first is not None else 0
        self._applied: set[int] = set()

    # ------------------------------------------------------------- append
    def append(self, tenant: str | None, pid: int, values) -> int:
        """Buffer one record into the active segment; returns its LSN.
        Durability requires a subsequent :meth:`commit`.

        **All-or-nothing on failure.**  A write that raises mid-record
        (ENOSPC, EIO, an injected torn write) must not leave a partial
        record in the segment: the torn-tail scan stops a segment at its
        first bad record, so stray bytes here would silently drop every
        *later* record in the segment at recovery.  On any write failure
        the segment is truncated back to the pre-append offset and the
        LSN is un-assigned (nothing else can have taken one — the lock is
        held); if even the rollback fails, the fd is marked broken and
        the next append rotates to a fresh segment, leaving the partial
        record as a scannable torn tail instead of a mid-segment hole.
        """
        v = np.ascontiguousarray(values)
        header = json.dumps(
            {
                "tenant": tenant,
                "pid": int(pid),
                "dtype": str(v.dtype),
                "shape": list(v.shape),
                "nbytes": int(v.nbytes),
            }
        ).encode()
        payload = v.tobytes()
        crc = binascii.crc32(payload, binascii.crc32(header))
        faults.hit("wal.append", tenant=tenant, pid=pid)
        with self._lock:
            if self._fence_epoch is not None and self.epoch < self._fence_epoch:
                # a follower was promoted past us: this log's writer is a
                # deposed primary and must never extend the history
                raise PrimaryFenced(self.epoch, self._fence_epoch)
            lsn = self._next_lsn
            if (
                self._fd is None
                or self._fd_broken
                or self._fd.tell() >= self.segment_bytes
            ):
                self._roll(lsn)
            buf = _WAL_PREFIX.pack(_WAL_MAGIC, lsn, crc, len(header))
            data = buf + header + payload
            pos = self._fd.tell()
            try:
                torn = faults.hit("wal.append.torn", lsn=lsn, size=len(data))
                if torn is not None:  # injected: write a prefix, then fail
                    self._fd.write(data[: int(torn)])
                    self._fd.flush()
                    raise OSError("injected torn write")
                self._fd.write(data)
                self._fd.flush()  # into the OS — commit() makes it durable
            except BaseException:
                self.append_rollbacks += 1
                try:  # roll the partial record back out of the segment
                    self._fd.seek(pos)
                    self._fd.truncate()
                except OSError:
                    self._fd_broken = True  # next append rotates
                raise
            self._next_lsn = lsn + 1
            self.appends += 1
            self.bytes_written += len(data)
            self._written_lsn = lsn
            self._mass[tenant] = self._mass.get(tenant, 0) + int(v.size)
            sm = self._seg_mass.setdefault(self._active_path, {})
            sm[tenant] = sm.get(tenant, 0) + int(v.size)
        return lsn

    def commit(self, upto: int | None = None) -> None:
        """Group commit: return once every append ≤ ``upto`` (default: all
        appends so far) is fsynced.  Concurrent committers share one
        fsync — the first through the lock syncs for everyone."""
        with self._lock:
            if upto is None:
                upto = self._written_lsn
        if not self.fsync_enabled:
            with self._lock:
                self._synced_lsn = max(self._synced_lsn, upto)
            return
        with self._commit_lock:
            if self._synced_lsn >= upto:
                return  # a concurrent committer's fsync covered us
            with self._lock:
                fd, latest = self._fd, self._written_lsn
            if fd is None:
                return

            def _sync() -> None:
                faults.hit("wal.fsync")
                os.fsync(fd.fileno())

            def _count(attempt: int, exc: BaseException) -> None:
                self.fsync_retries += 1

            t0 = time.perf_counter()
            # transient failures heal here (bounded backoff, jittered);
            # close() interrupts the wait, and the remaining attempts
            # still run — a persistent failure propagates to the
            # submitter, which surfaces it as backpressure
            retry_call(
                _sync,
                self.retry,
                wait=self._interrupt.wait,
                on_retry=_count,
            )
            dt = time.perf_counter() - t0
            self.fsyncs += 1
            self.fsync_seconds += dt
            self.last_fsync_seconds = dt
            # rotation fsyncs the outgoing segment, so syncing the active
            # fd covers every append ≤ latest
            self._synced_lsn = latest

    def log(self, tenant: str | None, pid: int, values) -> int:
        """:meth:`append` + :meth:`commit` — durable before return."""
        lsn = self.append(tenant, pid, values)
        self.commit(lsn)
        return lsn

    def _roll(self, first_lsn: int) -> None:
        """Rotate to a fresh segment (callers hold ``_lock``)."""
        if self._fd is not None:
            try:
                self._fd.flush()
                if self.fsync_enabled:
                    os.fsync(self._fd.fileno())
                synced = True
            except OSError:
                # a broken outgoing fd (failed append rollback): records
                # already committed were fsynced at their own commit; an
                # un-fsynced tail was never acked, and its loss is the
                # torn-tail scan's job — rotating away is the recovery
                synced = False
            try:
                self._fd.close()
            except OSError:
                # the outgoing records are fsynced (or were never acked);
                # count the failed close so stats() surfaces it
                self.close_errors += 1
            self._fd_broken = False
            # every record in the outgoing segment is ≤ written_lsn and
            # now durable; it becomes a closed, truncatable segment
            self._segments[self._active_path] = (
                self._segments[self._active_path][0],
                self._written_lsn,
            )
            if synced:
                self._synced_lsn = max(self._synced_lsn, self._written_lsn)
        self._active_path = os.path.join(self.dir, f"wal-{first_lsn:020d}.log")
        self._fd = open(self._active_path, "wb")
        # stamp the writer's epoch (fencing: a promoted follower's scan
        # and the dir transport reject lower-epoch history)
        self._fd.write(_SEG_HEADER.pack(_SEG_MAGIC, self.epoch))
        self._fd.flush()
        self._segments[self._active_path] = (first_lsn, first_lsn - 1)

    # ------------------------------------------------------ epoch fencing
    def _epoch_path(self) -> str:
        return os.path.join(self.dir, "epoch.json")

    def _load_epoch_state(self) -> tuple[int, int | None]:
        try:
            with open(self._epoch_path()) as f:
                st = json.load(f)
            fenced = st.get("fenced_at")
            return int(st.get("epoch", 0)), (
                None if fenced is None else int(fenced)
            )
        except (FileNotFoundError, ValueError, OSError):
            return 0, None

    def _store_epoch_state(self) -> None:
        atomic_write_json(
            self._epoch_path(),
            {"epoch": self.epoch, "fenced_at": self._fence_epoch},
            fsync=self.fsync_enabled,
        )

    # -------------------------------------------------- mass ledger
    @staticmethod
    def _decode_mass(d: dict) -> dict:
        return {(None if k == "" else k): int(v) for k, v in d.items()}

    @staticmethod
    def _encode_mass(d: dict) -> dict:
        return {("" if k is None else str(k)): int(v) for k, v in d.items() if v}

    def _load_mass_state(self) -> tuple[dict, dict]:
        """``(shed, pending)`` from mass.json: per-tenant mass truncated
        out of the log forever, plus per-segment charges written just
        before an unlink (reconciled at open if the unlink never ran)."""
        try:
            with open(mass_meta_path(self.dir)) as f:
                st = json.load(f)
            return (
                self._decode_mass(st.get("shed") or {}),
                {
                    name: self._decode_mass(mm)
                    for name, mm in (st.get("pending") or {}).items()
                },
            )
        except (FileNotFoundError, ValueError, OSError):
            return {}, {}

    def _store_mass_state(self, pending: dict | None = None) -> None:
        atomic_write_json(
            mass_meta_path(self.dir),
            {
                "shed": self._encode_mass(self._shed_mass),
                "pending": {
                    name: self._encode_mass(mm)
                    for name, mm in (pending or {}).items()
                },
            },
            fsync=self.fsync_enabled,
        )

    def shed_mass_by_tenant(self) -> dict:
        """Per-tenant mass of records truncated out of this log — state
        a follower can only obtain through a snapshot bootstrap
        (core/replication.py ``Replicator.bootstrap``)."""
        with self._lock:
            return {k: v for k, v in self._shed_mass.items() if v}

    def fence(self, min_epoch: int) -> None:
        """Reject every future append unless this log's epoch is ≥
        ``min_epoch`` (:class:`PrimaryFenced`).  Persisted: a deposed
        primary that restarts and reopens its log stays fenced."""
        min_epoch = int(min_epoch)
        with self._lock:
            if self._fence_epoch is None or min_epoch > self._fence_epoch:
                self._fence_epoch = min_epoch
                self._store_epoch_state()

    # ------------------------------------------------------- ship surface
    def segment_view(self) -> list[dict]:
        """Snapshot of the live segments for a tail reader (the
        replication shipper), LSN order.  ``size`` is the byte length
        that is safe to read now: for the active segment the flushed
        position — between appends that is always a record boundary, so
        a bounded read never sees a half-written record (a failed
        rollback leaves a torn tail, which the follower's incremental
        scan simply refuses to consume until it is overwritten)."""
        with self._lock:
            out = []
            for path, (first, _last) in sorted(
                self._segments.items(), key=lambda kv: kv[1][0]
            ):
                active = path == self._active_path
                if active and self._fd is not None:
                    size = self._fd.tell()
                else:
                    try:
                        size = os.path.getsize(path)
                    except FileNotFoundError:
                        # vanished out-of-band (operator rm, not our
                        # truncate — that untracks first): count it so
                        # stats() surfaces the anomaly, and skip
                        self.vanished_segments += 1
                        continue
                out.append(
                    {
                        "path": path,
                        "first_lsn": first,
                        "size": int(size),
                        "active": active,
                    }
                )
            return out

    def read_segment(
        self, path: str, offset: int = 0, length: int | None = None
    ) -> bytes | None:
        """Read ``length`` bytes of a segment from ``offset`` for a tail
        reader.  Returns ``None`` — the clean "segment rotated away"
        signal — when the file vanished because :meth:`truncate` deleted
        it between the reader's :meth:`segment_view` listing and this
        read.  (Before this contract existed the race surfaced as a
        FileNotFoundError indistinguishable from a torn-tail
        misdiagnosis.)  A missing file the log still *tracks* is a real
        I/O fault and raises."""
        try:
            with open(path, "rb") as f:
                if offset:
                    f.seek(int(offset))
                return f.read(-1 if length is None else int(length))
        except FileNotFoundError:
            with self._lock:
                if path in self._segments:
                    raise  # tracked but unreadable: not a rotation
            return None

    def read_active(self, offset: int) -> tuple[str, bytes, int] | None:
        """``(path, data, size)`` of the active segment from ``offset``
        to its current flushed boundary — measured and read atomically
        under the log lock, so a concurrent append *rollback* (which
        shrinks the file back to the pre-append boundary) can never
        interleave between the measure and the read and hand the shipper
        bytes the primary just disowned.  ``size < offset`` tells the
        shipper to truncate its copy back to ``size``.  ``None`` when no
        segment is active yet."""
        offset = int(offset)
        with self._lock:
            if self._fd is None or self._active_path is None:
                return None
            path = self._active_path
            size = self._fd.tell()
            if size <= offset:
                return path, b"", size
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(size - offset)
            return path, data, size

    def mass_by_tenant(self) -> dict:
        """Cumulative appended mass (value counts) per tenant route for
        the ship manifest (includes records recovered at open)."""
        with self._lock:
            return dict(self._mass)

    # ----------------------------------------------------- applied prefix
    def mark_applied(self, lsns) -> None:
        """Record that these LSNs were applied in-memory; advances the
        contiguous ``stable_lsn`` prefix that save-truncation uses."""
        with self._lock:
            for lsn in lsns:
                if lsn is not None:
                    self._applied.add(int(lsn))
            while self._stable + 1 in self._applied:
                self._applied.discard(self._stable + 1)
                self._stable += 1

    def ensure_position(self, last_lsn: int | None) -> None:
        """Advance the LSN horizon to at least ``last_lsn`` (idempotent).

        Recovery calls this with the snapshot's ``wal_stable_lsn``: if
        the log directory was emptied out-of-band (truncation itself
        always keeps the highest segment as an anchor) the next append
        must not reuse an LSN the snapshot already claims to cover —
        replay would silently skip it."""
        if last_lsn is None:
            return
        last_lsn = int(last_lsn)
        with self._lock:
            if self._next_lsn <= last_lsn:
                self._next_lsn = last_lsn + 1
                self._written_lsn = max(self._written_lsn, last_lsn)
                self._synced_lsn = max(self._synced_lsn, last_lsn)
                self._stable = max(self._stable, last_lsn)

    @property
    def stable_lsn(self) -> int:
        """Highest LSN of the contiguous applied prefix: every record ≤
        this was applied before *now*, so a snapshot whose state is read
        after this property returns covers all of them."""
        with self._lock:
            return self._stable

    # ------------------------------------------------------------ replay
    def recovered_records(self) -> list[WalRecord]:
        """The records found on disk when this log was opened, LSN order."""
        return list(self._recovered)

    def _scan(self):
        """Yield ``(path, first_lsn, [WalRecord], torn_count, epoch)``
        per segment in LSN order, stopping each segment at its first
        invalid record (torn tail ⇒ the ack for that record never
        returned).  A segment deleted by a concurrent :meth:`truncate`
        between the listing and the read is skipped — it rotated away
        with all of its records applied, which is not a torn tail."""
        try:
            names = sorted(
                n
                for n in os.listdir(self.dir)
                if n.startswith("wal-") and n.endswith(".log")
            )
        except FileNotFoundError:
            return
        for name in names:
            path = os.path.join(self.dir, name)
            try:
                first_lsn = int(name[len("wal-") : -len(".log")])
            except ValueError:
                continue  # not a segment file
            scanned = self._scan_segment(path)
            if scanned is None:
                continue  # rotated away under us
            records, torn, epoch = scanned
            yield path, first_lsn, records, torn, epoch

    @staticmethod
    def _scan_segment(path: str) -> tuple[list[WalRecord], int, int] | None:
        """``(records, torn_count, epoch)`` of one segment file, or
        ``None`` when the file vanished (truncated away concurrently)."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        epoch, at = read_segment_epoch(data)
        records, end = scan_wal_bytes(data, at)
        return records, (0 if end >= len(data) else 1), epoch

    # -------------------------------------------------------- truncation
    def truncate(self, stable: int | None = None) -> list[str]:
        """Delete every *closed* segment whose records are all ≤ ``stable``
        (default: the current applied prefix) — the save-side half of the
        truncation-on-save invariant.  Returns the deleted paths.

        The segment with the highest first-LSN always survives (as does
        the active one): it anchors the LSN horizon, so a process that
        reopens a fully-truncated log can never hand out LSNs the last
        snapshot's ``wal_stable_lsn`` already claims to cover.
        """
        stable = self.stable_lsn if stable is None else int(stable)
        removed = []
        with self._lock:
            horizon = max(
                (first for first, _last in self._segments.values()),
                default=None,
            )
            victims = [
                path
                for path, (first, last_valid) in self._segments.items()
                if not (
                    path == self._active_path
                    or first == horizon
                    or last_valid > stable
                )
            ]
            if not victims:
                return removed
            # charge the victims' mass to the durable shed ledger BEFORE
            # unlinking (listed as "pending" so a crash in between is
            # reconciled at the next open): the ship manifest's
            # cumulative mass must never silently lose the truncated
            # prefix, or a follower's drift bound would read 0 while it
            # is missing snapshot-covered history
            pending = {
                os.path.basename(p): dict(self._seg_mass.get(p, {}))
                for p in victims
            }
            for mm in pending.values():
                for k, m in mm.items():
                    self._shed_mass[k] = self._shed_mass.get(k, 0) + int(m)
            self._store_mass_state(pending)
            for path in victims:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    # already gone — its bytes left the log anyway; count
                    # the out-of-band removal like segment_files() does
                    self.vanished_segments += 1
                except OSError:
                    # cannot remove (e.g. EACCES): the segment stays in
                    # the log — give its charged mass back
                    for k, m in pending.pop(os.path.basename(path)).items():
                        self._shed_mass[k] = (
                            self._shed_mass.get(k, 0) - int(m)
                        )
                    continue
                del self._segments[path]
                self._seg_mass.pop(path, None)
                removed.append(path)
            self._store_mass_state()  # settle: pending cleared
        return removed

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Telemetry snapshot: depth (appended-but-not-yet-applied
        records), fsync latency/counts, segment/byte footprint."""
        with self._lock:
            return {
                "appends": self.appends,
                "append_rollbacks": self.append_rollbacks,
                "fsyncs": self.fsyncs,
                "fsync_retries": self.fsync_retries,
                "fsync_seconds_total": self.fsync_seconds,
                "last_fsync_seconds": self.last_fsync_seconds,
                "bytes_written": self.bytes_written,
                "segments": len(self._segments),
                "depth": self._written_lsn - self._stable,
                "written_lsn": self._written_lsn,
                "synced_lsn": self._synced_lsn,
                "stable_lsn": self._stable,
                "records_recovered": len(self._recovered),
                "torn_records_dropped": self.torn_records_dropped,
                "epoch": self.epoch,
                "fence_epoch": self._fence_epoch,
                "vanished_segments": self.vanished_segments,
                "close_errors": self.close_errors,
            }

    def close(self) -> None:
        self._interrupt.set()  # cut any in-flight commit backoff short
        with self._lock:
            if self._fd is not None:
                try:
                    self._fd.flush()
                    if self.fsync_enabled:
                        os.fsync(self._fd.fileno())
                finally:
                    self._fd.close()
                    self._fd = None


class PartialBatchFailure(Exception):
    """Raised by ``apply_batch`` to narrow the poison retry.

    When the callback knows which items of the batch are suspect (the
    registry applies per-tenant groups independently, so a failing group
    doesn't taint the groups that already applied), it raises this with
    just those items — the pool then retries *only them* one by one,
    instead of re-applying the whole batch.  Any other exception keeps
    the conservative whole-batch retry.
    """

    def __init__(self, items: list):
        super().__init__(f"{len(items)} item(s) failed")
        self.items = items


class PoolStateView:
    """Forwarding properties onto the owner's ``_pool`` (an IngestPool).

    Mixed into the store and the registry so their historical attribute
    surface keeps working — tests pin the error/flush synchronization by
    replacing ``_cv`` (and the per-owner errors alias) directly, and the
    pool reads these dynamically.  Each owner adds its own errors alias
    (``_async_errors`` / ``_errors``) since the record shapes differ.
    """

    @property
    def _cv(self) -> threading.Condition:
        return self._pool.cv

    @_cv.setter
    def _cv(self, value: threading.Condition) -> None:
        self._pool.cv = value

    @property
    def _pending(self) -> int:
        return self._pool.pending

    @property
    def _ingest_mutex(self) -> threading.Lock:
        return self._pool.ingest_mutex


class IngestPool:
    """Bounded-queue worker pool with batch drain + poison isolation."""

    def __init__(
        self,
        *,
        apply_batch: Callable[[list], None],
        wrap_error: Callable[[object, BaseException], object],
        workers: int = 1,
        queue_size: int = 1024,
        name: str = "ingest",
        on_batch_end: Callable[[list], None] | None = None,
        wal: "WriteAheadLog | None" = None,
        wal_record: Callable[[object], tuple] | None = None,
        retry: RetryPolicy | None = None,
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if wal is not None and wal_record is None:
            raise ValueError("wal requires a wal_record extractor")
        self.apply_batch = apply_batch
        self.wrap_error = wrap_error
        self.on_batch_end = on_batch_end
        # transient-fault policy: suspect items get this many attempts
        # (with interruptible backoff) before their error surfaces on
        # flush, and WAL appends retry under it before the submit is
        # rejected with backpressure
        self.retry = retry if retry is not None else RetryPolicy(
            attempts=3, base=0.005, cap=0.1
        )
        # durable-ingest plane (module docstring): every submit is
        # appended + group-commit-fsynced before it acks; wal_record maps
        # a queue item to its (tenant_route, pid, raw_values) log fields
        self.wal = wal
        self.wal_record = wal_record
        self.workers = int(workers)
        self.queue_size = int(queue_size)
        self.name = name
        # pending-count + error-record synchronization; owners may expose
        # (or tests may replace) this condition — always read via self.cv
        self.cv = threading.Condition(OrderedRLock("pool.cv"))
        self.pending = 0  # submitted-but-not-yet-processed items
        self.errors: list = []  # wrap_error records since the last drain
        # serializes submit against close(): without it a producer could
        # land an item behind the shutdown sentinel (or hit the torn-down
        # queue list) and strand it.  Workers never take this mutex, so
        # close() may hold it across join().
        self.ingest_mutex = OrderedLock("pool.ingest_mutex")
        self._state_lock = OrderedLock("pool._state_lock")  # queue/thread setup
        self._queues: list[queue.Queue] | None = None
        self._threads: list[threading.Thread] = []
        # set by close() BEFORE the sentinels go in: any worker sleeping
        # in a retry backoff wakes immediately, runs its remaining
        # attempts without sleeping, and reaches the sentinel — close()
        # never out-waits a backoff and never drops a retried batch
        self._closing = threading.Event()
        # self-healing observability (surfaced through health()/stats())
        self.batches = 0
        self.apply_retries = 0
        self.wal_append_retries = 0
        self.backpressure_rejects = 0
        # most recent backpressure rejection (reason/retry_after/at) —
        # health()["backpressure"] mirrors this so dashboards see pacing
        self.last_backpressure: dict | None = None
        # replication hook: called as on_durable() after a submit's WAL
        # commit lands (no pool locks held) — the Replicator ships here so
        # an ack implies the record reached every follower directory
        self.on_durable: Callable[[], None] | None = None

    # --------------------------------------------------------------- submit
    def submit(self, item, route: int = 0) -> None:
        """Enqueue one item (blocking only when the bounded queue is full).
        Items sharing ``route % workers`` are processed FIFO.

        With a WAL attached, the item is appended to the log before it is
        enqueued and fsynced (group commit) before this call returns — an
        acked submit is always replayable after a crash.  The fsync runs
        *outside* ``ingest_mutex`` so concurrent submitters batch into
        one fsync; a worker may apply the item before the fsync lands,
        which is harmless (if the process dies first, the ack never
        happened and the in-memory apply died with it).

        **Backpressure when the disk is sick.**  A WAL append that keeps
        failing after bounded retries rejects the submit with
        :class:`~repro_torch.core.resilience.IngestBackpressure` — nothing is
        enqueued, the caller owns the partition and may resubmit.  If the
        append landed but the group-commit fsync failed after retries,
        the item is already queued (it will be applied in-memory) but the
        call still raises backpressure: the durability ack would be a
        lie, and the caller must know it.
        """
        lsn = None
        with self.ingest_mutex:
            self._ensure_workers()
            if self.wal is not None:
                try:
                    lsn = retry_call(
                        lambda: self.wal.append(*self.wal_record(item)),
                        self.retry,
                        wait=self._closing.wait,
                        # epoch fencing is permanent, not a sick disk:
                        # never retried, never wrapped in backpressure
                        retryable=lambda e: not isinstance(e, PrimaryFenced),
                        on_retry=self._count_append_retry,
                    )
                except PrimaryFenced:
                    raise
                except BaseException as e:
                    raise self._backpressure(
                        "append",
                        f"WAL append failed after "
                        f"{self.retry.attempts} attempt(s): {e!r}",
                    ) from e
            with self.cv:
                self.pending += 1
            self._queues[route % self.workers].put((item, lsn))
        if self.wal is not None:
            try:
                self.wal.commit(lsn)  # durable before the ack
            except BaseException as e:
                raise self._backpressure(
                    "fsync",
                    "WAL fsync failed after retries — the partition was "
                    f"accepted in-memory but is NOT durable: {e!r}",
                ) from e
            if self.on_durable is not None:
                # ship-before-ack: a raising shipper fails the submit, so
                # the producer never sees an ack the followers don't hold
                self.on_durable()

    def _backpressure(self, reason: str, message: str) -> IngestBackpressure:
        """Count + remember a backpressure rejection and build the
        exception with its pacing hint (satellite: retry-after)."""
        retry_after = self.retry.retry_after()
        self.backpressure_rejects += 1
        self.last_backpressure = {
            "reason": reason,
            "retry_after": retry_after,
            "at": time.time(),
        }
        return IngestBackpressure(message, retry_after=retry_after)

    def _count_append_retry(self, attempt: int, exc: BaseException) -> None:
        self.wal_append_retries += 1

    def _count_apply_retry(self, attempt: int, exc: BaseException) -> None:
        self.apply_retries += 1

    def _retry_wait(self, delay: float) -> None:
        """Interruptible backoff sleep of the worker's per-item retry.
        The ``pool.retry`` failpoint fires first, so tests can sequence a
        close() against a worker provably parked in this wait."""
        faults.hit("pool.retry", delay=delay)
        self._closing.wait(delay)

    def _ensure_workers(self) -> None:
        with self._state_lock:
            if self._queues is not None and all(
                t.is_alive() for t in self._threads
            ):
                return
            self._closing.clear()
            self._queues = [
                queue.Queue(maxsize=self.queue_size)
                for _ in range(self.workers)
            ]
            self._threads = [
                threading.Thread(
                    target=self._drain_loop,
                    args=(q,),
                    name=f"{self.name}-{i}",
                    daemon=True,
                )
                for i, q in enumerate(self._queues)
            ]
            for t in self._threads:
                t.start()

    # ---------------------------------------------------------------- drain
    def _drain_loop(self, q: queue.Queue) -> None:
        while True:
            entry = q.get()
            if entry is _SENTINEL:
                return
            batch = [entry]  # [(item, lsn)] — lsn None without a WAL
            stop = False
            while True:  # drain whatever else is already queued — one flush
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            self._run_batch(batch)
            if stop:
                return

    def _run_batch(self, batch: list) -> None:
        items = [item for item, _lsn in batch]
        try:
            try:
                # chaos site: a worker "crash" mid-batch — the whole
                # batch becomes suspect and rides the per-item retry
                faults.hit("pool.batch", size=len(items))
                self.apply_batch(items)
            except PartialBatchFailure as pf:
                suspects = pf.items
            except BaseException:
                suspects = items
            else:
                suspects = ()
            # isolate the poison rows: retry the suspect items one at a
            # time — each under the bounded backoff policy, so transient
            # faults heal on the worker — so a single bad item cannot
            # drop the valid items drained into the same batch (errors
            # surface on the owner's flush()).  The retries run HERE,
            # inside the batch, before the pending count drops — close()'s
            # shutdown sentinel (and drain()'s pending wait) therefore
            # cannot overtake an in-flight retry and drop the
            # still-pending non-poisoned items; the backoff sleeps wait
            # on the closing event, so close() bounds them without
            # skipping the remaining attempts (pinned by the
            # deterministic close-vs-retry interleavings in
            # tests/test_durability.py and tests/test_faults.py).
            for item in suspects:
                try:
                    retry_call(
                        lambda item=item: self.apply_batch([item]),
                        self.retry,
                        wait=self._retry_wait,
                        on_retry=self._count_apply_retry,
                    )
                except BaseException as e:
                    # build the record BEFORE taking cv: wrap_error may be
                    # a registry callback that trips the tenant's circuit
                    # breaker under registry._lock — taking that under cv
                    # inverts the lock hierarchy (witness-pinned in
                    # tests/test_lock_witness.py)
                    rec = self.wrap_error(item, e)
                    with self.cv:  # pairs with drain()'s swap-read
                        self.errors.append(rec)
            if self.on_batch_end is not None:
                try:
                    self.on_batch_end(items)
                except BaseException as e:
                    rec = self.wrap_error(None, e)  # outside cv, as above
                    with self.cv:
                        self.errors.append(rec)
        finally:
            if self.wal is not None:
                # the whole batch — poison included — is done with the
                # worker: advance the applied prefix so truncation-on-save
                # can reclaim its segments (the WAL guards against
                # crashes, not bad data; poison errors surfaced above)
                self.wal.mark_applied(lsn for _item, lsn in batch)
            with self.cv:
                self.batches += 1
                self.pending -= len(batch)
                self.cv.notify_all()

    # ----------------------------------------------------------- lifecycle
    def drain(self) -> list:
        """Block until every submitted item is processed; swap out and
        return the accumulated error records (the owner formats/raises)."""
        with self.cv:
            while self.pending > 0:
                self.cv.wait()
            # swap-read under cv: workers append under the same lock, so a
            # batch failing concurrently with this drain can neither vanish
            # into the swapped-out list nor be reported twice
            errs, self.errors = self.errors, []
        return errs

    def close(self) -> None:
        """Drain each queue, stop the workers.  Safe to call repeatedly;
        the next submit() restarts the pool transparently.

        Bounded even against an in-flight retry backoff: the closing
        event is set *before* the sentinels go in, so a worker parked in
        a backoff sleep wakes immediately, finishes its remaining retry
        attempts without sleeping, and reaches the sentinel — the
        retried batch is never dropped and the join never out-waits a
        backoff schedule."""
        self._closing.set()
        with self.ingest_mutex:
            with self._state_lock:
                threads, queues = self._threads, self._queues
                self._threads, self._queues = [], None
            if queues is not None:
                for q in queues:
                    q.put(_SENTINEL)
                for t in threads:
                    t.join()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Self-healing counters for health()/telemetry surfaces."""
        with self.cv:
            pending = self.pending
            errors_pending = len(self.errors)
            batches = self.batches
        return {
            "pending": pending,
            "errors_pending": errors_pending,
            "batches": batches,
            "apply_retries": self.apply_retries,
            "wal_append_retries": self.wal_append_retries,
            "backpressure_rejects": self.backpressure_rejects,
            "backpressure": self.last_backpressure,
        }
