"""Hot-standby replication: WAL shipping, bounded-staleness replicas,
zero-loss failover.

PyTorch port of ``repro.core.replication`` (same names, lock ranks and
failpoint sites).  The shipped formats are the reference's byte for byte
— segment frames, ``manifest.json``, ``epoch.json``, ``bootstrap.json``
and the ``registry.npz`` snapshot blob — so a primary of either package
can feed a follower of the other.  A :class:`Follower` builds its
registry with the given ``registry_kwargs`` (its ``device`` too, which
also places a bootstrap snapshot), so WAL replay on a replica summarizes
and pulls up on the card unless it is given ``device="cpu"``.

The write-ahead log made a *process* crash-safe: every acked ingest is
in it, and recovery replays it.  The process itself remained a single
point of failure — when it dies, serving stops until local recovery completes.
This module removes that: a :class:`Replicator` on the primary ships WAL
segment bytes to N follower directories *before the ingest ack*, a
:class:`Follower` tails the shipped segments and continuously replays
them into its own :class:`~repro_torch.core.tenant.TenantRegistry` (the same
idempotent pid-dedup/watermark reconciliation recovery uses), and
``Follower.promote()`` is first-class failover: fence the deposed
primary by epoch, drain the shipped suffix, adopt the shipped log as the
new primary's WAL, re-attach subscription planes.

Zero acked loss, by construction
--------------------------------
The shipper runs on the ingest ack path: ``IngestPool.submit`` calls its
``on_durable`` hook after the group-commit fsync and *before* returning,
and the synchronous ingest path ships right after its commit + apply
(core/tenant.py ``_replication_ship``, outside the tenant's
breaker-attributed try — a replication outage fails the ingest but never
quarantines the tenant).  A ship failure therefore fails the submit —
the producer never holds an ack the follower directories don't hold
bytes for.  The streams are byte-level and idempotent: each
frame means "the segment's content from ``offset`` is exactly these
bytes; truncate anything beyond", so re-shipping after a partial failure
converges instead of corrupting.  A follower may hold *more* than the
acked set (appends whose ack never returned) — the same harmless
superset a local recovery replays, and the chaos harness's bit-match
oracle is superset-tolerant for exactly this reason.

Epoch fencing
-------------
``promote(fence=...)`` picks ``new_epoch`` = 1 + the highest epoch it
has observed and (best-effort) calls the fence callable against the old
primary: ``WriteAheadLog.fence(new_epoch)`` persists a fence mark that
makes every later ``append`` raise
:class:`~repro_torch.core.resilience.PrimaryFenced` — a deposed primary's late
writes are rejected *at its own log*, even across a restart.  The
follower directory is fenced too: its ``epoch.json`` is bumped to
``new_epoch`` (under the same per-directory gate the dir transport
sends through, so an in-flight ship cannot slip bytes past the fence),
and both in-tree transports refuse to deliver frames stamped with a
lower epoch.  Segment files carry their writer's epoch in a 12-byte
header (core/workers.py); a follower configured with ``min_epoch``
additionally refuses to *apply* records from lower-epoch segments.

Snapshot bootstrap
------------------
``checkpoint()`` truncates snapshot-covered segments out of the WAL, so
a standby attached *after* a checkpoint can never receive that prefix
as log bytes.  Two pieces keep this from becoming silent data loss: the
WAL's durable shed-mass ledger (core/workers.py ``mass.json``) keeps
``mass_by_tenant()`` cumulative across truncation and restart, so the
manifest always claims the full history and an un-bootstrapped replica
degrades honestly; and ``Replicator.bootstrap`` ships the snapshot
itself (plus a ``bootstrap.json`` seed crediting the covered mass) as
atomic blobs, so a fresh :class:`Follower` adopts the snapshot-covered
state and serves non-degraded, bit-matching answers.  When shed mass
exists and the snapshot cannot be shipped, ``bootstrap`` refuses rather
than under-replicate.

Bounded-staleness replica reads
-------------------------------
Each ship writes a ``manifest.json`` next to the shipped segments:
``{epoch, written_lsn, mass, wall}`` where ``mass`` is the primary's
cumulative appended value-count per tenant.  The follower's drift bound
for a tenant is ``manifest mass − mass it has scanned`` (clamped at 0):
every unit of mass the replica provably hasn't seen can shift bucket
ranks by at most itself, which is exactly the currency of the paper's
ε guarantee — so ``Follower.query_many`` serves answers with ``eps``
widened by that bound, as :class:`~repro_torch.core.resilience.Answer` objects
carrying ``lag_seconds``.  ``degraded=True`` marks every answer that
cannot be proven to bit-match the primary's acked state: the tenant has
nonzero drift, the manifest is missing, or the manifest's age exceeds
the configured staleness SLO.  A non-degraded replica answer therefore
bit-matches a fault-free replica — the invariant the chaos property
test machine-checks.

Locks: ``repl.replicator`` (rank 2) and ``repl.follower`` (rank 4) sit
*below* the whole serving hierarchy — ship/tail call into registry,
store and WAL locks, never the reverse; ``repl.dirgate`` (rank 5) is the
per-follower-directory send-vs-fence gate.  Failpoints: ``repl.ship`` /
``repl.tail`` / ``repl.apply`` / ``repl.promote`` (core/failpoints.py).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Callable

from repro_torch.analysis.witness import OrderedLock
from repro_torch.core import failpoints as faults
from repro_torch.core.resilience import Answer, PrimaryFenced
from repro_torch.core.tenant import TenantRegistry
from repro_torch.core.workers import (
    WriteAheadLog,
    atomic_write_json,
    mass_meta_path,
    read_segment_epoch,
    scan_wal_bytes,
)

__all__ = [
    "DirTransport",
    "Follower",
    "Replicator",
    "StreamReceiver",
    "StreamTransport",
    "manifest_path",
]

_MANIFEST = "manifest.json"
_FRAME_LEN = struct.Struct("<I")  # stream frame: header length prefix
_ACK = struct.Struct("<BQ")  # stream ack: status byte + receiver epoch

# per-follower-directory gate serializing transport sends against the
# promote-time fence write: a send that passed the epoch check cannot
# land its bytes after the fence, so promote's final drain is exact
_DIR_GATES: dict[str, OrderedLock] = {}
_DIR_GATES_GUARD = threading.Lock()


def _dir_gate(dir: str) -> OrderedLock:
    key = os.path.abspath(dir)
    with _DIR_GATES_GUARD:
        gate = _DIR_GATES.get(key)
        if gate is None:
            gate = _DIR_GATES[key] = OrderedLock("repl.dirgate")
        return gate


def manifest_path(dir: str) -> str:
    return os.path.join(dir, _MANIFEST)


def _dir_epoch(dir: str) -> int:
    """The epoch recorded in a directory's ``epoch.json`` (0 if none)."""
    try:
        with open(os.path.join(dir, "epoch.json")) as f:
            return int(json.load(f).get("epoch", 0))
    except (FileNotFoundError, ValueError, OSError):
        return 0


def _apply_frame(dir: str, name: str, offset: int, data: bytes) -> None:
    """One ship frame: segment content from ``offset`` is exactly
    ``data``; anything beyond is truncated away (idempotent)."""
    path = os.path.join(dir, os.path.basename(name))
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    with os.fdopen(fd, "r+b") as f:
        f.seek(int(offset))
        f.write(data)
        f.truncate(int(offset) + len(data))


def _apply_blob(dir: str, name: str, data: bytes) -> None:
    """One whole auxiliary file (snapshot bootstrap), written atomically
    — a reader never sees a torn blob, unlike the truncate-as-you-go
    segment frame files."""
    path = os.path.join(dir, os.path.basename(name))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _check_epoch(dir: str, epoch: int) -> None:
    dest = _dir_epoch(dir)
    if dest > epoch:
        raise PrimaryFenced(epoch, dest)


class DirTransport:
    """Ship frames into a local follower directory (files by basename).

    Every delivery runs under the directory's ``repl.dirgate`` and
    re-checks the directory's epoch inside it: once a promotion bumped
    ``epoch.json`` past the sender's epoch, frames from the deposed
    primary raise :class:`PrimaryFenced` and *nothing* lands — not even
    a frame whose epoch check raced the fence write.
    """

    def __init__(self, dir: str):
        self.dir = str(dir)
        os.makedirs(self.dir, exist_ok=True)

    def send(self, name: str, offset: int, data: bytes, *, epoch: int) -> None:
        with _dir_gate(self.dir):
            _check_epoch(self.dir, epoch)
            _apply_frame(self.dir, name, offset, data)

    def send_blob(self, name: str, data: bytes, *, epoch: int) -> None:
        with _dir_gate(self.dir):
            _check_epoch(self.dir, epoch)
            _apply_blob(self.dir, name, data)

    def send_manifest(self, manifest: dict, *, epoch: int) -> None:
        with _dir_gate(self.dir):
            _check_epoch(self.dir, epoch)
            # not a durability artifact (losing it costs lag-unknown,
            # never data) — skip the fsync on the hot ack path
            atomic_write_json(
                manifest_path(self.dir), manifest, fsync=False
            )

    def close(self) -> None:
        pass


class StreamTransport:
    """Ship frames over a byte stream (socketpair/loopback) to a
    :class:`StreamReceiver`.  Each frame is acknowledged synchronously —
    the ingest ack is only issued once the receiver wrote the bytes —
    and a fenced receiver acks a rejection that surfaces here as
    :class:`PrimaryFenced`."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def _roundtrip(self, header: dict, payload: bytes) -> None:
        blob = json.dumps(header).encode()
        self.sock.sendall(_FRAME_LEN.pack(len(blob)) + blob + payload)
        ack = _recv_exact(self.sock, _ACK.size)
        status, dest_epoch = _ACK.unpack(ack)
        if status != 1:
            raise PrimaryFenced(int(header["epoch"]), int(dest_epoch))

    def send(self, name: str, offset: int, data: bytes, *, epoch: int) -> None:
        self._roundtrip(
            {
                "kind": "frame",
                "name": os.path.basename(name),
                "offset": int(offset),
                "length": len(data),
                "epoch": int(epoch),
            },
            data,
        )

    def send_blob(self, name: str, data: bytes, *, epoch: int) -> None:
        self._roundtrip(
            {
                "kind": "blob",
                "name": os.path.basename(name),
                "length": len(data),
                "epoch": int(epoch),
            },
            data,
        )

    def send_manifest(self, manifest: dict, *, epoch: int) -> None:
        blob = json.dumps(manifest).encode()
        self._roundtrip(
            {"kind": "manifest", "length": len(blob), "epoch": int(epoch)},
            blob,
        )

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("replication stream closed mid-frame")
        buf += chunk
    return buf


class StreamReceiver:
    """Follower-side end of a :class:`StreamTransport`: a daemon thread
    that applies each frame into the follower directory (under the same
    dirgate/epoch discipline as :class:`DirTransport`) and acks it.

    ``close()`` joins the thread — after it returns no further bytes can
    land, which is what lets ``promote()`` on a stream-fed follower
    simply stop the receiver before its final drain."""

    def __init__(self, sock: socket.socket, dir: str):
        self.sock = sock
        self.dir = str(dir)
        os.makedirs(self.dir, exist_ok=True)
        self.frames = 0
        self.rejected = 0
        self.faults = 0  # stream terminations, incl. apply failures
        self._thread = threading.Thread(
            target=self._serve, name="repl-receiver", daemon=True
        )
        self._thread.start()

    def _serve(self) -> None:
        try:
            while True:
                (hlen,) = _FRAME_LEN.unpack(
                    _recv_exact(self.sock, _FRAME_LEN.size)
                )
                header = json.loads(_recv_exact(self.sock, hlen))
                payload = _recv_exact(self.sock, int(header["length"]))
                epoch = int(header["epoch"])
                with _dir_gate(self.dir):
                    dest = _dir_epoch(self.dir)
                    if dest > epoch:
                        self.rejected += 1
                        self.sock.sendall(_ACK.pack(0, dest))
                        continue
                    if header["kind"] == "frame":
                        _apply_frame(
                            self.dir,
                            header["name"],
                            int(header["offset"]),
                            payload,
                        )
                    elif header["kind"] == "blob":
                        _apply_blob(self.dir, header["name"], payload)
                    else:
                        atomic_write_json(
                            manifest_path(self.dir),
                            json.loads(payload),
                            fsync=False,
                        )
                    self.frames += 1
                self.sock.sendall(_ACK.pack(1, dest))
        except (ConnectionError, OSError, ValueError):
            # peer closed, close() shut us down, OR a follower-side
            # fault (disk error applying a frame, malformed header).
            # Either way the stream is dead: shut it down so a sender
            # blocked in its ack wait gets ConnectionError and fails
            # the submit fast, instead of wedging the primary's ingest
            # ack path forever.
            self.faults += 1
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._thread.join()
        self.sock.close()


class Replicator:
    """Primary-side shipper: WAL segment bytes → N follower transports.

    ``ship()`` is incremental and idempotent: it tracks a shipped byte
    offset per segment, reads closed segments lock-free (they are
    immutable; one deleted underneath by ``truncate()`` returns the
    clean rotated-away ``None`` and is dropped from tracking) and the
    active segment atomically under the WAL lock
    (:meth:`~repro_torch.core.workers.WriteAheadLog.read_active` — an append
    rollback can never hand the shipper disowned bytes).  After shipping
    it publishes the manifest capturing ``written_lsn`` and the
    per-tenant appended mass *as of before the reads* — a lower bound of
    what the followers now hold, which keeps the follower's drift bound
    honest.

    Wire it onto a registry with :meth:`attach`: every durable ack then
    ships first (module docstring).  All shipping serializes under
    ``repl.replicator`` (rank 2 — below every lock it calls into).
    """

    def __init__(self, wal: WriteAheadLog, transports):
        self.wal = wal
        self.transports = list(transports)
        self._lock = OrderedLock("repl.replicator")
        self._offsets: dict[str, int] = {}  # segment path -> bytes shipped
        self.ships = 0
        self.bytes_shipped = 0
        self.ship_failures = 0
        self.shipped_lsn = 0

    def attach(self, registry: TenantRegistry) -> "Replicator":
        """Put this shipper on the registry's ingest ack paths (both the
        async pool's post-commit hook and the synchronous ingest hook)
        and on its ``health()["replication"]`` row."""
        registry._replication = self
        registry._pool.on_durable = self.ship
        return self

    def bootstrap(self, snapshot_path: str) -> bool:
        """Ship the checkpoint snapshot plus a seed-mass record so a
        fresh follower can reconstruct state the WAL no longer holds.

        A primary restarted after a ``checkpoint()`` has truncated the
        snapshot-covered prefix out of its log; shipping only the WAL
        suffix would leave followers *silently* missing that history
        (their drift bound would read 0 against a manifest that excluded
        it).  When the log has shed mass this call is mandatory and
        raises if it cannot run — no snapshot on disk, or a transport
        without ``send_blob`` — rather than under-replicate; with
        nothing shed it is a best-effort catch-up accelerator.  The
        seed record (``bootstrap.json``) carries the shed per-tenant
        mass so the follower's drift bound credits the snapshot-covered
        prefix it will never see as WAL bytes.  Returns True when the
        snapshot was shipped.
        """
        shed = self.wal.shed_mass_by_tenant()
        needed = any(shed.values())
        have = os.path.exists(snapshot_path)
        with self._lock:
            carriers = [
                tr for tr in self.transports if hasattr(tr, "send_blob")
            ]
            if needed and (not have or len(carriers) < len(self.transports)):
                raise ValueError(
                    "WAL no longer holds snapshot-covered history (shed "
                    f"mass {sum(shed.values())}) and the followers cannot "
                    "be bootstrapped: "
                    + (
                        f"no snapshot at {snapshot_path}"
                        if not have
                        else "a transport does not support send_blob"
                    )
                )
            if not have:
                return False
            with open(snapshot_path, "rb") as f:
                blob = f.read()
            seed = json.dumps(
                {
                    "epoch": self.wal.epoch,
                    "mass": {
                        ("" if t is None else str(t)): int(m)
                        for t, m in shed.items()
                    },
                }
            ).encode()
            # snapshot first, seed second: a follower that sees the seed
            # requires the snapshot it credits to already be in place
            for tr in carriers:
                tr.send_blob("registry.npz", blob, epoch=self.wal.epoch)
                tr.send_blob("bootstrap.json", seed, epoch=self.wal.epoch)
        return True

    def ship(self) -> int:
        """Ship every unshipped WAL byte to every follower; returns the
        byte count.  Raises on any transport failure (the caller — the
        ingest ack path — must not ack) after counting it."""
        faults.hit("repl.ship")
        with self._lock:
            try:
                return self._ship_locked()
            except BaseException:
                self.ship_failures += 1
                raise

    def _ship_locked(self) -> int:
        # capture the manifest numbers BEFORE reading segment bytes: both
        # only grow, so everything they claim is contained in what the
        # reads below deliver — the manifest never overstates a follower
        st = self.wal.stats()
        mass = self.wal.mass_by_tenant()
        view = self.wal.segment_view()
        live = {seg["path"] for seg in view}
        for path in list(self._offsets):
            if path not in live:
                del self._offsets[path]  # truncated away: follower keeps it
        sent = 0
        for seg in view:
            path = seg["path"]
            off = self._offsets.get(path, 0)
            end: int | None = seg["size"]
            if seg["active"]:
                got = self.wal.read_active(off)
                if got is not None and got[0] == path:
                    _apath, data, cur = got
                    if cur < off:
                        # append rollback shrank the segment: rewind the
                        # copies
                        self._send(path, cur, b"")
                        self._offsets[path] = cur
                        continue
                    if data:
                        self._send(path, off, data)
                        self._offsets[path] = off + len(data)
                        sent += len(data)
                    continue
                # the log rotated (or closed) between segment_view() and
                # read_active(): ``path`` is closed and immutable NOW, so
                # ship its remaining tail through the closed-segment read
                # in this same round — the manifest published below
                # claims these bytes, and the ingest ack must never
                # return while the followers lack them
                end = None
            if end is not None and off >= end:
                continue
            data = self.wal.read_segment(
                path, off, None if end is None else end - off
            )
            if data is None:
                self._offsets.pop(path, None)  # rotated away
                continue
            if data:
                self._send(path, off, data)
                self._offsets[path] = off + len(data)
                sent += len(data)
        if sent or self.ships == 0:
            manifest = {
                "epoch": self.wal.epoch,
                "written_lsn": st["written_lsn"],
                "mass": {
                    ("" if t is None else str(t)): int(m)
                    for t, m in mass.items()
                },
                "wall": time.time(),
            }
            for tr in self.transports:
                tr.send_manifest(manifest, epoch=self.wal.epoch)
            self.shipped_lsn = st["written_lsn"]
        self.ships += 1
        self.bytes_shipped += sent
        return sent

    def _send(self, path: str, offset: int, data: bytes) -> None:
        for tr in self.transports:
            tr.send(path, offset, data, epoch=self.wal.epoch)

    def heartbeat(self) -> None:
        """Publish a fresh manifest without requiring new bytes — keeps
        the followers' seconds-lag honest across idle stretches."""
        with self._lock:
            manifest = {
                "epoch": self.wal.epoch,
                "written_lsn": self.wal.stats()["written_lsn"],
                "mass": {
                    ("" if t is None else str(t)): int(m)
                    for t, m in self.wal.mass_by_tenant().items()
                },
                "wall": time.time(),
            }
            for tr in self.transports:
                tr.send_manifest(manifest, epoch=self.wal.epoch)

    def fence(self, min_epoch: int) -> None:
        """The promote-side fence hook: persist the fence mark on this
        primary's WAL so its later appends raise :class:`PrimaryFenced`."""
        self.wal.fence(min_epoch)

    def close(self) -> None:
        for tr in self.transports:
            tr.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "role": "primary",
                "epoch": self.wal.epoch,
                "followers": len(self.transports),
                "ships": self.ships,
                "bytes_shipped": self.bytes_shipped,
                "ship_failures": self.ship_failures,
                "shipped_lsn": self.shipped_lsn,
            }


class Follower:
    """Replica-side tailer: shipped segments → a live registry.

    Owns (or adopts) a :class:`TenantRegistry` with no WAL of its own —
    the shipped directory *is* its log, adopted wholesale at
    :meth:`promote`.  A shipped ``registry.npz`` + ``bootstrap.json``
    pair (:meth:`Replicator.bootstrap`) is adopted at construction:
    the snapshot becomes the starting registry and its covered mass is
    credited to the drift bound — that is how checkpoint-truncated
    history reaches a fresh replica.  ``tail()`` incrementally parses new segment bytes
    from remembered offsets and applies fresh records through the same
    grouped summarizer + pid/watermark dedup recovery uses, so tailing
    is idempotent: a fault between apply and state-commit re-scans the
    same bytes and the dedup skips what already landed.  State under
    ``repl.follower`` (rank 4, below the registry/store locks the apply
    path takes).
    """

    def __init__(
        self,
        dir: str,
        *,
        registry: TenantRegistry | None = None,
        min_epoch: int = 0,
        staleness_slo: float | None = None,
        clock: Callable[[], float] = time.time,
        **registry_kwargs,
    ):
        self.dir = str(dir)
        os.makedirs(self.dir, exist_ok=True)
        boot_registry: TenantRegistry | None = None
        boot_mass: dict[str, int] = {}
        if registry is None:
            snap = os.path.join(self.dir, "registry.npz")
            if os.path.exists(snap):
                # snapshot bootstrap (Replicator.bootstrap): the primary
                # checkpointed history out of its WAL — adopt the shipped
                # snapshot and credit its covered mass, so the drift
                # bound starts honest instead of silently reading 0
                try:
                    boot_registry = TenantRegistry.load(
                        snap, device=registry_kwargs.get("device")
                    )
                    with open(os.path.join(self.dir, "bootstrap.json")) as f:
                        boot_mass = {
                            str(t): int(m)
                            for t, m in (
                                json.load(f).get("mass") or {}
                            ).items()
                        }
                except Exception:
                    # torn/corrupt bootstrap: start empty and credit
                    # nothing — the drift bound then *includes* the
                    # missing prefix, so the replica degrades honestly
                    # instead of answering wrong
                    if boot_registry is not None:
                        boot_registry.close()
                    boot_registry = None
                    boot_mass = {}
        self.registry = (
            registry
            if registry is not None
            else (
                boot_registry
                if boot_registry is not None
                else TenantRegistry(**registry_kwargs)
            )
        )
        self._boot_mass = boot_mass
        self.min_epoch = int(min_epoch)
        self.staleness_slo = (
            None if staleness_slo is None else float(staleness_slo)
        )
        self.clock = clock
        self._lock = OrderedLock("repl.follower")
        self._offsets: dict[str, int] = {}  # basename -> bytes consumed
        self._epochs: dict[str, int] = {}  # basename -> segment epoch
        self._data_start: dict[str, int] = {}  # basename -> header size
        # pre-dedup scanned mass, seeded with the bootstrap snapshot's
        # covered mass (the prefix this replica holds without ever
        # seeing its WAL bytes)
        self._seen_mass: dict[str, int] = dict(boot_mass)
        self.applied_lsn = 0
        self.tails = 0
        self.records_applied = 0
        self.apply_failures = 0
        self.fenced_segments_skipped = 0
        self.promoted_epoch: int | None = None

    # ----------------------------------------------------------- tailing
    def tail(self) -> int:
        """One tail pass: scan new shipped bytes, apply fresh records,
        commit offsets.  Returns the number of records applied."""
        faults.hit("repl.tail")
        with self._lock:
            applied, touched = self._tail_locked()
        if touched:
            # stale notifications with no locks held (tenant.py contract)
            self.registry._notify_stale(sorted(touched))
        return applied

    def _tail_locked(self) -> tuple[int, set]:
        progress = []  # (basename, new_offset, [records])
        for name in self._segment_names():
            scanned = self._scan_one(name)
            if scanned is not None:
                progress.append(scanned)
        records = sorted(
            (r for _n, _o, recs in progress for r in recs),
            key=lambda r: r.lsn,
        )
        per_tenant: dict[str, dict] = {}
        for rec in records:
            if rec.tenant is None:
                continue  # standalone-store log shipped by mistake
            per_tenant.setdefault(str(rec.tenant), {})[rec.pid] = rec.values
        applied = 0
        touched: set[str] = set()
        try:
            for tenant, parts in sorted(per_tenant.items()):
                faults.hit("repl.apply", tenant=tenant, parts=len(parts))
                store = self.registry.tenant(tenant)
                fresh = {
                    pid: v
                    for pid, v in parts.items()
                    if pid not in store.summaries
                    and (store.watermark is None or pid > store.watermark)
                }
                if fresh:
                    store._apply(store._summarize_batch(fresh))
                    store._maybe_sweep()
                    applied += len(fresh)
                    touched.add(tenant)
        except BaseException:
            self.apply_failures += 1
            raise  # offsets NOT committed: the next tail re-scans + dedups
        # every group applied: commit scan state atomically
        for name, new_off, recs in progress:
            self._offsets[name] = new_off
            for rec in recs:
                key = "" if rec.tenant is None else str(rec.tenant)
                self._seen_mass[key] = self._seen_mass.get(key, 0) + int(
                    rec.values.size
                )
                if rec.lsn > self.applied_lsn:
                    self.applied_lsn = rec.lsn
        self.tails += 1
        self.records_applied += applied
        return applied, touched

    def _segment_names(self) -> list[str]:
        try:
            return sorted(
                n
                for n in os.listdir(self.dir)
                if n.startswith("wal-") and n.endswith(".log")
            )
        except FileNotFoundError:
            return []

    def _scan_one(self, name: str):
        """``(name, new_offset, records)`` of one segment's unread tail,
        or ``None`` when there is nothing new."""
        path = os.path.join(self.dir, name)
        off = self._offsets.get(name, 0)
        try:
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if size < off:
                    # the primary rewound this segment (append rollback
                    # frame): nothing beyond a record boundary was ever
                    # consumed, so just adopt the shorter length
                    self._offsets[name] = size
                    return None
                f.seek(off)
                data = f.read()
        except FileNotFoundError:
            return None  # vanished under us — re-listed next pass
        if off == 0:
            epoch, start = read_segment_epoch(data)
            self._epochs[name] = epoch
            self._data_start[name] = start
            data = data[start:]
            off = start
        if not data:
            return None
        if self._epochs.get(name, 0) < self.min_epoch:
            # a fenced (deposed-primary) segment: never apply, but keep
            # the offset pinned so repeated tails stay O(new bytes) —
            # and count only when bytes actually arrived, so idle tail
            # polling doesn't inflate the stat
            self.fenced_segments_skipped += 1
            return (name, off + len(data), [])
        records, consumed = scan_wal_bytes(data, 0)
        if not records:
            return None  # incomplete record tail — retry once more arrives
        return (name, off + consumed, records)

    # --------------------------------------------------------------- lag
    def _read_manifest(self) -> dict | None:
        try:
            with open(manifest_path(self.dir)) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError, OSError):
            return None

    def lag(self) -> dict:
        """The replica's staleness snapshot against the last manifest:
        ``records`` (LSN gap), ``seconds`` (manifest age), ``mass``
        (total drift bound), ``known`` False when no manifest shipped
        yet (everything else ``None`` — honesty over guesses)."""
        manifest = self._read_manifest()
        with self._lock:
            applied = self.applied_lsn
            seen = dict(self._seen_mass)
        if manifest is None:
            return {
                "known": False,
                "records": None,
                "seconds": None,
                "mass": None,
                "epoch": None,
            }
        mass = sum(
            max(0, int(m) - seen.get(t, 0))
            for t, m in (manifest.get("mass") or {}).items()
        )
        return {
            "known": True,
            "records": max(0, int(manifest.get("written_lsn", 0)) - applied),
            "seconds": max(0.0, self.clock() - float(manifest.get("wall", 0))),
            "mass": mass,
            "epoch": int(manifest.get("epoch", 0)),
        }

    def drift_by_tenant(self) -> dict[str, int] | None:
        """Per-tenant mass-drift bound (``None`` = unknown, no manifest):
        how much appended mass the primary claims that this replica
        provably hasn't scanned — the ε-widening currency of
        :meth:`query_many`."""
        manifest = self._read_manifest()
        if manifest is None:
            return None
        with self._lock:
            seen = dict(self._seen_mass)
        return {
            t: max(0, int(m) - seen.get(t, 0))
            for t, m in (manifest.get("mass") or {}).items()
        }

    # ------------------------------------------------------------ queries
    def query_many(
        self,
        queries,
        beta: int,
        *,
        strict: bool = False,
        deadline: float | None = None,
    ) -> list:
        """Replica-side batch answering with bounded staleness.

        Answers come from the follower's own registry (one merge
        dispatch, the normal serving path) and are wrapped as
        :class:`~repro_torch.core.resilience.Answer` with ``eps`` widened by
        the tenant's mass-drift bound and ``lag_seconds`` attached.
        ``degraded=True`` whenever the answer cannot be proven current:
        the underlying answer was already degraded, the tenant's drift
        is nonzero, no manifest is known, or the manifest's age exceeds
        ``staleness_slo``.  With no manifest the widening is ``inf`` —
        an honest "we cannot bound this" instead of a guess.
        """
        lag = self.lag()
        drift = self.drift_by_tenant()
        over_slo = self.staleness_slo is not None and (
            not lag["known"] or lag["seconds"] > self.staleness_slo
        )
        answers = self.registry.query_many(
            queries, beta, strict=strict, degraded_ok=True, deadline=deadline
        )
        out = []
        for (name, _lo, _hi), ans in zip(queries, answers):
            hist, eps = ans
            if drift is None:
                widen: float = float("inf")
                stale = True
            else:
                widen = float(drift.get(str(name), 0))
                stale = widen > 0
            degraded = (
                bool(getattr(ans, "degraded", False)) or stale or over_slo
            )
            out.append(
                Answer.make(
                    hist,
                    eps + widen,
                    degraded=degraded,
                    stale_version=getattr(ans, "stale_version", None),
                    lag_seconds=lag["seconds"],
                )
            )
        return out

    # ----------------------------------------------------------- failover
    def promote(
        self,
        *,
        fence: Callable[[int], None] | None = None,
        epoch: int | None = None,
        planes=(),
        receivers=(),
    ) -> TenantRegistry:
        """First-class failover: fence the old primary, drain the
        shipped suffix, adopt the shipped log as this registry's WAL,
        re-attach subscription planes.  Returns the (now primary-role)
        registry.

        ``fence`` is called with the new epoch against the old primary
        (e.g. ``replicator.fence`` or ``wal.fence``) — best-effort, a
        dead primary that cannot be reached is exactly the scenario
        (its persisted ``epoch.json`` fence closes the gap if it ever
        restarts).  ``receivers`` (stream-fed followers) are closed
        *before* the final drain so no frame can land after it;
        dir-transport senders are fenced by the ``epoch.json`` bump
        under the directory gate.  ``planes`` are
        :class:`~repro_torch.serve.subscriptions.SubscriptionPlane` objects to
        re-home onto the promoted registry.
        """
        faults.hit("repl.promote")
        manifest = self._read_manifest()
        with self._lock:
            observed = [self.min_epoch, _dir_epoch(self.dir)]
            observed.extend(self._epochs.values())
            if manifest is not None:
                observed.append(int(manifest.get("epoch", 0)))
        new_epoch = (
            max(observed) + 1 if epoch is None else int(epoch)
        )
        if fence is not None:
            try:
                fence(new_epoch)
            except (OSError, ConnectionError):
                pass  # a dead/unreachable primary is already fenced by fate
        for rc in receivers:
            rc.close()
        # bulk drain, then fence our own directory (under the send gate:
        # a dir-transport frame in flight either landed before — caught
        # by the final drain — or raises PrimaryFenced at the sender,
        # failing its ack), then catch the stragglers
        while self.tail():
            pass
        with _dir_gate(self.dir):
            atomic_write_json(
                os.path.join(self.dir, "epoch.json"),
                {"epoch": new_epoch, "fenced_at": None},
            )
        while self.tail():
            pass
        # adopt the shipped segments as the promoted primary's own WAL:
        # a fresh higher-epoch segment for new appends, everything
        # already applied marked so checkpoint truncation works.  The
        # bootstrap snapshot's covered mass goes into the adopted log's
        # durable shed ledger first, so this promoted primary's own
        # ship manifests stay cumulative for *its* future followers.
        if any(self._boot_mass.values()):
            atomic_write_json(
                mass_meta_path(self.dir),
                {
                    "shed": {
                        t: int(m)
                        for t, m in self._boot_mass.items()
                        if m
                    },
                    "pending": {},
                },
            )
        wal = WriteAheadLog(self.dir, epoch=new_epoch)
        wal.mark_applied(r.lsn for r in wal.recovered_records())
        reg = self.registry
        reg.wal_dir = self.dir
        reg._wal = wal
        reg._pool.wal = wal
        reg._pool.wal_record = lambda item: (item[0], item[1], item[2])
        for plane in planes:
            plane.reattach(reg)
        self.promoted_epoch = new_epoch
        return reg

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        lag = self.lag()
        with self._lock:
            return {
                "role": (
                    "replica" if self.promoted_epoch is None else "primary"
                ),
                "epoch": (
                    self.promoted_epoch
                    if self.promoted_epoch is not None
                    else lag["epoch"]
                ),
                "applied_lsn": self.applied_lsn,
                "tails": self.tails,
                "records_applied": self.records_applied,
                "apply_failures": self.apply_failures,
                "fenced_segments_skipped": self.fenced_segments_skipped,
                "lag": lag,
            }

    def close(self) -> None:
        self.registry.close()
