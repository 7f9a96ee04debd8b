"""Port parity: ``repro_torch.core.replication`` against ``repro``'s.

Mirrors every case of ``tests/test_replication.py``, the ``subs.*`` and
``repl.*`` cases of ``tests/test_failpoint_sites.py`` and, at a fixed
small size, the replication case of ``tests/test_chaos_props.py``.  Each
mirrored case is one scenario run twice on the same seeded NumPy inputs,
through the reference package and through the port (``device="cpu"``:
the kernels' plain versions), each in a directory of its own.  The
reference test's assertions hold for both runs, and what a scenario
returns — replica answers with their widened ε and degraded flags, byte
counts, drift bounds — is then held equal between the packages, answers
bit for bit.

Two more cases cross the packages: a reference primary shipping to a port
follower, and a port primary shipping to a reference follower.  The
shipped segment, manifest, epoch and bootstrap formats are shared, so
both followers give bit-equal answers and the same drift.

Sequencing is deterministic (explicit tails, flush barriers, injected
interleavings) — no sleeps anywhere.
"""
import contextlib
import json
import os
import socket
import struct
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R
import repro.core.replication as R_repl
import repro.core.scrub as R_scrub
import repro.core.workers as R_workers
import repro.serve as RS
import repro_torch.core as C
import repro_torch.core.replication as C_repl
import repro_torch.core.scrub as C_scrub
import repro_torch.core.workers as C_workers
import repro_torch.serve as CS

if os.environ.get("REPRO_LOCK_WITNESS") == "1":
    # tests/conftest.py arms only the reference's witness
    from repro_torch.analysis import witness as _witness

    _witness.arm()

REF = SimpleNamespace(
    name="ref", core=R, repl=R_repl, workers=R_workers, scrub=R_scrub,
    serve=RS, kw={},
)
PORT = SimpleNamespace(
    name="port", core=C, repl=C_repl, workers=C_workers, scrub=C_scrub,
    serve=CS, kw={"device": "cpu"},
)
T = 8
BETA = 16


@pytest.fixture(autouse=True)
def _disarm():
    R.faults.reset()
    C.faults.reset()
    yield
    R.faults.reset()
    C.faults.reset()


def _vals(rng, n=96):
    return rng.normal(size=n).astype(np.float32)


def _reg(pkg, **kw):
    return pkg.core.TenantRegistry(num_buckets=T, **pkg.kw, **kw)


def _primary(pkg, root, name="pwal", **kw):
    return _reg(pkg, wal_dir=os.path.join(root, name), **kw)


def _follower(pkg, dir, **kw):
    return pkg.repl.Follower(dir, num_buckets=T, **pkg.kw, **kw)


def _service(pkg, dir, **kw):
    return pkg.serve.HistogramService(dir, num_buckets=T, **pkg.kw, **kw)


def _bitmatch(a, b, queries, beta=BETA):
    """Assert two registries answer ``queries`` identically, bit for bit."""
    ra = a.query_many(queries, beta, strict=False)
    rb = b.query_many(queries, beta, strict=False)
    for (ha, ea), (hb, eb) in zip(ra, rb):
        assert ea == eb
        assert (ha is None) == (hb is None)
        if ha is not None:
            np.testing.assert_array_equal(
                np.asarray(ha.boundaries), np.asarray(hb.boundaries)
            )
            np.testing.assert_array_equal(
                np.asarray(ha.sizes), np.asarray(hb.sizes)
            )


def _facts(x):
    """A comparable form of a scenario's result: answers become the bits
    of their arrays, their ε and degraded flag."""
    if isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "sizes"):
        b, s = np.asarray(x[0].boundaries), np.asarray(x[0].sizes)
        return (
            "answer", b.dtype.str, b.tobytes(), s.dtype.str, s.tobytes(),
            float(x[1]), bool(getattr(x, "degraded", False)),
        )
    if isinstance(x, tuple) and len(x) == 2 and x[0] is None:
        return ("answer", None, float(x[1]), bool(getattr(x, "degraded", False)))
    if isinstance(x, (list, tuple)):
        return [_facts(v) for v in x]
    if isinstance(x, dict):
        return {k: _facts(v) for k, v in x.items()}
    return x


def _same(scenario, root, *args):
    """Run ``scenario`` on both packages, each in its own directory under
    ``root``; what they return must agree (answers bit for bit)."""
    out = {}
    for pkg in (REF, PORT):
        d = os.path.join(str(root), pkg.name)
        os.makedirs(d)
        out[pkg.name] = scenario(pkg, d, *args)
    assert _facts(out["ref"]) == _facts(out["port"])
    return out["port"]


# --------------------------------------------------------------- transports
def _dir_ship_tail(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(
        reg._wal, [pkg.repl.DirTransport(standby)]
    ).attach(reg)
    rng = np.random.default_rng(0)
    for pid in range(4):
        reg.ingest("t", pid, _vals(rng))  # sync path ships per ingest
    f = _follower(pkg, standby)
    assert f.tail() == 4
    _bitmatch(reg, f.registry, [("t", 0, 7)])
    lag = f.lag()
    assert lag["known"] and lag["records"] == 0 and lag["mass"] == 0
    st = repl.stats()
    assert st["shipped_lsn"] == 4 and st["ship_failures"] == 0
    out = f.query_many([("t", 0, 7), ("t", 1, 2)], BETA) + [
        st["bytes_shipped"]
    ]
    f.close()
    reg.close()
    return out


def test_dir_ship_tail_bitmatch(tmp_path):
    _same(_dir_ship_tail, tmp_path)


def _stream_ship(pkg, root):
    standby = os.path.join(root, "standby")
    a, b = socket.socketpair()
    recv = pkg.repl.StreamReceiver(b, standby)
    reg = _primary(pkg, root)
    pkg.repl.Replicator(
        reg._wal, [pkg.repl.StreamTransport(a)]
    ).attach(reg)
    rng = np.random.default_rng(1)
    reg.ingest("t", 0, _vals(rng))
    reg.ingest_async("t", 1, _vals(rng))  # async path ships via on_durable
    reg.flush()
    f = _follower(pkg, standby)
    assert f.tail() == 2
    _bitmatch(reg, f.registry, [("t", 0, 3)])
    out = f.query_many([("t", 0, 3)], BETA)
    with open(os.path.join(standby, "epoch.json"), "w") as fh:
        json.dump({"epoch": 7}, fh)
    with pytest.raises(pkg.core.PrimaryFenced):
        reg.ingest("t", 2, _vals(rng))
    assert recv.rejected >= 1
    recv.close()
    f.close()
    reg.close()
    return out


def test_stream_ship_tail_bitmatch_and_fence(tmp_path):
    _same(_stream_ship, tmp_path)


def _torn_frame(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    tr = pkg.repl.DirTransport(standby)
    repl = pkg.repl.Replicator(reg._wal, [tr]).attach(reg)
    rng = np.random.default_rng(2)
    reg.ingest("t", 0, _vals(rng))
    f = _follower(pkg, standby)
    assert f.tail() == 1
    reg._replication = None  # detach auto-ship for the manual frame
    reg._pool.on_durable = None
    reg.ingest("t", 1, _vals(rng))
    view = reg._wal.segment_view()[-1]
    shipped = repl._offsets[view["path"]]
    whole = reg._wal.read_active(shipped)[1]
    tr.send(view["path"], shipped, whole[: len(whole) // 2], epoch=0)
    assert f.tail() == 0  # torn tail: nothing consumed, nothing applied
    assert repl.ship() == len(whole)  # re-ship from the tracked offset
    assert f.tail() == 1  # the full frame overwrote the torn bytes
    _bitmatch(reg, f.registry, [("t", 0, 3)])
    out = f.query_many([("t", 0, 3)], BETA) + [len(whole)]
    f.close()
    reg.close()
    return out


def test_frame_is_idempotent_and_torn_tail_refused(tmp_path):
    """A half-shipped record is refused by the follower's scan until the
    re-ship overwrites it."""
    _same(_torn_frame, tmp_path)


def _incremental(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(
        reg._wal, [pkg.repl.DirTransport(standby)]
    ).attach(reg)
    rng = np.random.default_rng(3)
    reg.ingest("t", 0, _vals(rng))
    shipped = repl.bytes_shipped
    assert repl.ship() == 0  # nothing new: no bytes move
    assert repl.bytes_shipped == shipped
    reg.ingest("t", 1, _vals(rng))
    assert repl.bytes_shipped > shipped
    reg.close()
    return [shipped, repl.bytes_shipped]


def test_ship_is_incremental(tmp_path):
    """Byte counts too are the reference's: the shipped bytes are the same
    WAL format."""
    _same(_incremental, tmp_path)


# ---------------------------------------- tail reader vs truncate() (race)
def _rotated_away(pkg, root):
    wal = pkg.workers.WriteAheadLog(
        os.path.join(root, "wal"), segment_bytes=256
    )
    rng = np.random.default_rng(4)
    lsns = [wal.append("t", pid, _vals(rng)) for pid in range(6)]
    wal.commit()
    view = wal.segment_view()
    assert len(view) > 2, "segments must have rotated for this test"
    victim = view[0]["path"]
    wal.mark_applied(lsns)
    assert victim in wal.truncate()
    assert wal.read_segment(victim, 0, 16) is None  # clean signal
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(wal, [pkg.repl.DirTransport(standby)])
    repl._offsets[victim] = 7
    repl.ship()
    assert victim not in repl._offsets
    f = _follower(pkg, standby)
    f.tail()
    assert f.stats()["apply_failures"] == 0
    out = [f.stats()["records_applied"], repl.bytes_shipped]
    f.close()
    wal.close()
    return out


def test_read_segment_rotated_away_is_clean_none(tmp_path):
    _same(_rotated_away, tmp_path)


def _vanished(pkg, root):
    wal = pkg.workers.WriteAheadLog(
        os.path.join(root, "wal"), segment_bytes=256
    )
    rng = np.random.default_rng(5)
    for pid in range(6):
        wal.append("t", pid, _vals(rng))
    wal.commit()
    victim = wal.segment_view()[0]
    assert not victim["active"]
    os.remove(victim["path"])
    with pytest.raises(FileNotFoundError):
        wal.read_segment(victim["path"], 0, 16)
    before = len(wal.segment_view())
    assert wal.stats()["vanished_segments"] >= 1
    assert before == len(wal.segment_view())  # stable, just skipped
    wal.close()
    return [before]


def test_vanished_tracked_segment_is_an_anomaly_not_masked(tmp_path):
    _same(_vanished, tmp_path)


def _rewind(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(
        reg._wal, [pkg.repl.DirTransport(standby)]
    ).attach(reg)
    rng = np.random.default_rng(6)
    reg.ingest("t", 0, _vals(rng))
    f = _follower(pkg, standby)
    assert f.tail() == 1
    view = reg._wal.segment_view()[-1]
    true_off = repl._offsets[view["path"]]
    repl._offsets[view["path"]] = true_off + 64
    name = os.path.basename(view["path"])
    with open(os.path.join(standby, name), "ab") as fh:
        fh.write(b"\x00" * 64)  # the disowned bytes on the follower
    repl.ship()
    assert repl._offsets[view["path"]] == true_off
    assert os.path.getsize(os.path.join(standby, name)) == true_off
    reg.ingest("t", 1, _vals(rng))
    assert f.tail() == 1  # tailing resumes cleanly at the boundary
    _bitmatch(reg, f.registry, [("t", 0, 3)])
    out = f.query_many([("t", 0, 3)], BETA) + [true_off]
    f.close()
    reg.close()
    return out


def test_rewind_frame_shrinks_follower_copy(tmp_path):
    _same(_rewind, tmp_path)


def _rotation_race(pkg, root):
    wal = pkg.workers.WriteAheadLog(os.path.join(root, "wal"))
    rng = np.random.default_rng(20)
    for pid in range(3):
        wal.append("t", pid, _vals(rng))
    wal.commit()
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(wal, [pkg.repl.DirTransport(standby)])
    real = wal.read_active

    def rotated(off):
        got = real(off)
        return None if got is None else (got[0] + ".next", b"", 0)

    wal.read_active = rotated
    sent = repl.ship()
    assert sent > 0  # the closed tail moved this round
    del wal.read_active
    assert repl.shipped_lsn == 3
    f = _follower(pkg, standby)
    assert f.tail() == 3  # every byte the manifest claims is present
    lag = f.lag()
    assert lag["known"] and lag["records"] == 0 and lag["mass"] == 0
    out = f.query_many([("t", 0, 2)], BETA) + [sent]
    f.close()
    wal.close()
    return out


def test_ship_rotation_race_ships_closed_tail_same_round(tmp_path):
    _same(_rotation_race, tmp_path)


def _receiver_fault(pkg, root):
    a, b = socket.socketpair()
    recv = pkg.repl.StreamReceiver(b, os.path.join(root, "standby"))
    tr = pkg.repl.StreamTransport(a)
    a.settimeout(10.0)  # regression guard: error, never an infinite hang
    a.sendall(struct.pack("<I", 8) + b"notjson!")
    with pytest.raises((ConnectionError, OSError)):
        tr.send("wal-x.log", 0, b"y", epoch=0)
    assert recv.faults >= 1
    recv.close()
    tr.close()
    return []


def test_receiver_fault_fails_sender_fast_instead_of_wedging(tmp_path):
    _same(_receiver_fault, tmp_path)


def _fenced_quiet(pkg, root):
    wal = pkg.workers.WriteAheadLog(os.path.join(root, "wal"), epoch=2)
    rng = np.random.default_rng(21)
    wal.append("t", 0, _vals(rng))
    wal.commit()
    wal.close()
    f = _follower(pkg, os.path.join(root, "wal"), min_epoch=3)
    assert f.tail() == 0
    baseline = f.stats()["fenced_segments_skipped"]
    assert baseline == 1
    for _ in range(4):
        assert f.tail() == 0
    assert f.stats()["fenced_segments_skipped"] == baseline
    f.close()
    return [baseline]


def test_fenced_skip_counter_quiet_on_idle_tails(tmp_path):
    _same(_fenced_quiet, tmp_path)


class _Down:
    def send(self, *a, **k):
        raise OSError("replication down")

    def send_manifest(self, *a, **k):
        raise OSError("replication down")

    def close(self):
        pass


def _ship_failure(pkg, root):
    reg = _reg(
        pkg,
        wal_dir=os.path.join(root, "wal"),
        breaker=pkg.core.BreakerPolicy(threshold=1, cooldown=1000.0),
    )
    repl = pkg.repl.Replicator(reg._wal, [_Down()]).attach(reg)
    rng = np.random.default_rng(22)
    with pytest.raises(OSError):
        reg.ingest("t", 0, _vals(rng))  # ship failed: no ack
    assert repl.stats()["ship_failures"] == 1
    health = reg.health()
    assert health["quarantined"] == []
    assert health["breakers"]["t"]["state"] == "closed"
    reg._replication = None
    reg._pool.on_durable = None
    reg.ingest("t", 1, _vals(rng))
    out = reg.query_many([("t", 0, 1)], BETA)
    reg.close()
    return out


def test_ship_failure_does_not_quarantine_tenant(tmp_path):
    _same(_ship_failure, tmp_path)


# --------------------------------------------- snapshot bootstrap (standby)
def _mass_ledger(pkg, root):
    WAL = pkg.workers.WriteAheadLog
    wal = WAL(os.path.join(root, "wal"), segment_bytes=256)
    rng = np.random.default_rng(23)
    lsns = [wal.append("t", pid, _vals(rng)) for pid in range(6)]
    wal.commit()
    wal.mark_applied(lsns)
    total = wal.mass_by_tenant()["t"]
    assert wal.truncate(), "segments must actually be deleted"
    assert wal.mass_by_tenant()["t"] == total
    shed = wal.shed_mass_by_tenant()["t"]
    assert shed > 0
    wal.close()
    wal2 = WAL(os.path.join(root, "wal"))
    assert wal2.mass_by_tenant()["t"] == total
    assert wal2.shed_mass_by_tenant()["t"] == shed
    wal2.close()
    return [total, shed]


def test_wal_mass_survives_truncate_and_reopen(tmp_path):
    _same(_mass_ledger, tmp_path)


def _bootstrap(pkg, root):
    pdir, sdir = os.path.join(root, "primary"), os.path.join(root, "standby")
    svc = _service(pkg, pdir)
    svc.registry._wal.segment_bytes = 256  # rotate per record
    rng = np.random.default_rng(24)
    acked = {}
    for pid in range(4):
        v = _vals(rng)
        svc.record("m", pid, v)
        acked[pid] = v
    svc.checkpoint()  # truncates the covered segments out of the WAL
    assert svc.registry._wal.shed_mass_by_tenant(), "history must be shed"
    svc.close()
    svc = _service(pkg, pdir, replicate_to=(sdir,))
    v = _vals(rng)
    svc.record("m", 4, v)
    acked[4] = v
    rep = _service(pkg, sdir, role="replica")
    rep.sync()
    [ans] = rep.query_many([("m", 0, 7)], BETA)
    assert not ans.degraded  # provably complete — not silently partial
    oracle = _reg(pkg)
    for pid, val in acked.items():
        oracle.ingest("m", pid, val)
    _bitmatch(oracle, rep.registry, [("m", 0, 7)])
    fence = svc.replicator.fence
    del svc
    rep.promote(fence=fence)
    _bitmatch(oracle, rep.registry, [("m", 0, 7)])
    rep.close()
    svc2 = _service(pkg, sdir)
    _bitmatch(oracle, svc2.registry, [("m", 0, 7)])
    out = [ans] + svc2.query_many([("m", 0, 7), ("m", 2, 4)], BETA)
    svc2.close()
    oracle.close()
    return out


def test_standby_bootstrap_after_checkpoint(tmp_path):
    """A primary restarted with ``replicate_to`` after a checkpoint: the
    snapshot bootstrap carries the truncated prefix, the replica answers
    complete and non-degraded, and failover loses nothing."""
    _same(_bootstrap, tmp_path)


def _unshippable(pkg, root):
    pdir, sdir = os.path.join(root, "primary"), os.path.join(root, "standby")
    svc = _service(pkg, pdir)
    svc.registry._wal.segment_bytes = 256
    rng = np.random.default_rng(25)
    for pid in range(4):
        svc.record("m", pid, _vals(rng))
    svc.checkpoint()
    svc.close()
    os.remove(os.path.join(pdir, "registry.npz"))
    with pytest.raises(ValueError, match="bootstrap"):
        _service(pkg, pdir, replicate_to=(sdir,))
    return []


def test_replicate_to_refused_when_history_unshippable(tmp_path):
    _same(_unshippable, tmp_path)


def _blob(pkg, root):
    a, b = socket.socketpair()
    standby = os.path.join(root, "standby")
    recv = pkg.repl.StreamReceiver(b, standby)
    tr = pkg.repl.StreamTransport(a)
    tr.send_blob("bootstrap.json", b'{"mass": {}}', epoch=0)
    with open(os.path.join(standby, "bootstrap.json"), "rb") as f:
        assert f.read() == b'{"mass": {}}'
    assert not os.path.exists(os.path.join(standby, "bootstrap.json.tmp"))
    recv.close()
    tr.close()
    return []


def test_stream_blob_delivery_is_atomic(tmp_path):
    _same(_blob, tmp_path)


# ------------------------------------------------- backpressure (satellite)
def _backpressure(pkg, root):
    reg = _primary(pkg, root)
    reg._pool.retry = pkg.core.RetryPolicy(
        attempts=1, base=0.05, cap=1.0, jitter=0.0
    )
    rng = np.random.default_rng(7)
    with pkg.core.faults.inject("wal.append", exc=OSError(28, "ENOSPC")):
        with pytest.raises(pkg.core.IngestBackpressure) as ei:
            reg.ingest_async("t", 0, _vals(rng))
    assert ei.value.retry_after == pytest.approx(0.05)
    row = reg.health()["backpressure"]
    assert row["reason"] == "append"
    assert row["retry_after"] == pytest.approx(0.05)
    assert row["at"] > 0
    reg.ingest_async("t", 0, _vals(rng))
    reg.flush()
    assert reg.health()["backpressure"]["reason"] == "append"
    out = reg.query_many([("t", 0, 0)], BETA)
    reg.close()
    return out


def test_backpressure_carries_retry_after_and_health_row(tmp_path):
    _same(_backpressure, tmp_path)


# ------------------------------------------------------------ epoch fencing
def _fence_reopen(pkg, root):
    WAL = pkg.workers.WriteAheadLog
    wal = WAL(os.path.join(root, "wal"))
    rng = np.random.default_rng(8)
    wal.append("t", 0, _vals(rng))
    wal.commit()
    wal.fence(3)
    with pytest.raises(pkg.core.PrimaryFenced):
        wal.append("t", 1, _vals(rng))
    wal.close()
    wal2 = WAL(os.path.join(root, "wal"))
    with pytest.raises(pkg.core.PrimaryFenced):
        wal2.append("t", 1, _vals(rng))
    wal2.close()
    wal3 = WAL(os.path.join(root, "wal"), epoch=3)
    lsn = wal3.append("t", 1, _vals(rng))
    assert lsn > 0
    assert wal3.stats()["epoch"] == 3
    wal3.close()
    return [lsn]


def test_fence_rejects_appends_and_survives_reopen(tmp_path):
    _same(_fence_reopen, tmp_path)


def _writer_epoch(pkg, root):
    wal = pkg.workers.WriteAheadLog(os.path.join(root, "wal"), epoch=2)
    rng = np.random.default_rng(9)
    wal.append("t", 0, _vals(rng))
    wal.commit()
    path = wal.segment_view()[0]["path"]
    with open(path, "rb") as fh:
        epoch, hdr = pkg.workers.read_segment_epoch(fh.read())
    assert epoch == 2 and hdr > 0
    wal.close()
    f = _follower(pkg, os.path.join(root, "wal"), min_epoch=3)
    assert f.tail() == 0
    assert f.stats()["fenced_segments_skipped"] >= 1
    f.close()
    return [epoch, hdr]


def test_segments_carry_writer_epoch(tmp_path):
    _same(_writer_epoch, tmp_path)


def _fenced_ack(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    pkg.repl.Replicator(reg._wal, [pkg.repl.DirTransport(standby)]).attach(reg)
    rng = np.random.default_rng(10)
    reg.ingest("t", 0, _vals(rng))
    f = _follower(pkg, standby)
    f.tail()
    f.promote()  # no fence callable: the deposed primary is unreachable
    with pytest.raises(pkg.core.PrimaryFenced):
        reg.ingest("t", 1, _vals(rng))
    out = [f.promoted_epoch]
    f.close()
    reg.close()
    return out


def test_dir_transport_fenced_after_promote_fails_the_ack(tmp_path):
    _same(_fenced_ack, tmp_path)


# ------------------------------------------------------- failover (service)
def _promote(pkg, root):
    pdir = os.path.join(root, "primary")
    sdir = os.path.join(root, "standby")
    svc = _service(pkg, pdir, replicate_to=(sdir,))
    rng = np.random.default_rng(11)
    acked = {}
    for pid in range(5):
        v = _vals(rng)
        svc.record("m", pid, v)  # returned = acked = shipped
        acked[pid] = v
    rep = _service(pkg, sdir, role="replica")
    with pytest.raises(pkg.core.NotPrimary):
        rep.record("m", 9, _vals(rng))
    sub = rep.subscribe("m", 0, 7, beta=BETA)
    rep.sync()
    fence = svc.replicator.fence
    del svc
    rep.promote(fence=fence)
    assert rep.role == "primary"
    oracle = _reg(pkg)
    for pid, v in acked.items():
        oracle.ingest("m", pid, v)
    _bitmatch(oracle, rep.registry, [("m", 0, 7)])
    rep.record("m", 5, _vals(rng))
    rep.subscriptions.flush()
    ups = sub.drain()
    assert ups and ups[-1].version == rep.registry["m"].version
    assert rep.health()["role"] == "primary"
    assert rep.health()["replication"]["role"] == "primary"
    out = [(ups[-1].hist, ups[-1].eps)]
    rep.close()
    oracle.close()
    svc2 = _service(pkg, sdir)
    assert svc2.registry["m"].version > 0
    out += svc2.query_many([("m", 0, 7)], BETA)
    svc2.close()
    return out


def test_service_promote_zero_loss_and_plane_reattach(tmp_path):
    _same(_promote, tmp_path)


# ------------------------------------------------ bounded-staleness reads
def _widen(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(
        reg._wal, [pkg.repl.DirTransport(standby)]
    ).attach(reg)
    rng = np.random.default_rng(12)
    for pid in range(3):
        reg.ingest("t", pid, _vals(rng, 128))
    now = [0.0]
    f = _follower(pkg, standby, staleness_slo=5.0, clock=lambda: now[0])
    f.tail()
    with open(pkg.repl.manifest_path(standby)) as fh:
        now[0] = json.load(fh)["wall"]
    fresh = f.query_many([("t", 0, 3)], BETA)[0]
    base_eps = reg.query_many([("t", 0, 3)], BETA, strict=False)[0][1]
    assert fresh.eps == base_eps and not fresh.degraded
    assert fresh.lag_seconds == pytest.approx(0.0, abs=1e-6)
    reg.ingest("t", 3, _vals(rng, 200))
    stale = f.query_many([("t", 0, 3)], BETA)[0]
    assert stale.degraded
    assert stale.eps == pytest.approx(base_eps + 200)
    assert f.drift_by_tenant()["t"] == 200
    f.tail()
    healed = f.query_many([("t", 0, 3)], BETA)[0]
    assert not healed.degraded and healed.eps < stale.eps
    now[0] += 100.0
    over = f.query_many([("t", 0, 3)], BETA)[0]
    assert over.degraded and over.lag_seconds > 5.0
    os.remove(pkg.repl.manifest_path(standby))
    unknown = f.query_many([("t", 0, 3)], BETA)[0]
    assert unknown.degraded and unknown.eps == float("inf")
    assert f.lag()["known"] is False
    f.close()
    repl.close()
    reg.close()
    return [fresh, stale, healed, over, unknown]


def test_replica_reads_widen_eps_and_flag_degraded(tmp_path):
    """Replica answers and their widened ε bit-equal to the reference's:
    fresh, drifted, healed, over the SLO, and with no manifest."""
    _same(_widen, tmp_path)


# ------------------------------------------------------- scrub divergence
def _divergence(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    pkg.repl.Replicator(reg._wal, [pkg.repl.DirTransport(standby)]).attach(reg)
    rng = np.random.default_rng(13)
    for pid in range(3):
        reg.ingest("t", pid, _vals(rng))
    f = _follower(pkg, standby)
    f.tail()
    rep = pkg.scrub.scrub_divergence(reg, f.registry)
    assert rep["ok"] and rep["checked"] == 3 and rep["diverged"] == {}
    reg._replication = None
    reg._pool.on_durable = None
    reg.ingest("t", 3, _vals(rng))
    rep = pkg.scrub.scrub_divergence(reg, f.registry)
    assert rep["ok"] and rep["behind"] == {"t": [3]}
    s = f.registry["t"].summaries[0]
    rotted = np.array(s.sizes, copy=True)
    rotted[0] += 1.0
    object.__setattr__(s, "sizes", rotted)
    rep = pkg.scrub.scrub_divergence(reg, f.registry)
    assert not rep["ok"] and rep["diverged"] == {"t": [0]}
    f.close()
    reg.close()
    return [rep]


def test_scrub_divergence_detects_lag_and_corruption(tmp_path):
    _same(_divergence, tmp_path)


# ------------------------------------ failpoint sites (subs.*, repl.*)
def _plane_with_sub(pkg):
    reg = _reg(pkg)
    plane = pkg.serve.SubscriptionPlane(reg)
    sub = plane.subscribe("m", 0, 8, 16)
    rng = np.random.default_rng(0)
    reg.ingest("m", 0, rng.normal(size=64))
    plane.flush()
    [first] = sub.drain()
    assert not first.degraded  # primed: last-known-good is recorded
    return reg, plane, sub


def _subs_eval(pkg, root):
    reg, plane, sub = _plane_with_sub(pkg)
    try:
        rng = np.random.default_rng(1)
        with pkg.core.faults.inject("subs.eval"):
            reg.ingest("m", 1, rng.normal(size=64))
            plane.flush()
            ups = sub.drain()
            assert ups and all(u.degraded for u in ups)
            assert plane.eval_failures >= 1
            deg = ups[-1]
        plane.flush()  # healed: the still-stale window re-evaluates fresh
        ups = sub.drain()
        assert ups and not ups[-1].degraded
        assert ups[-1].version == reg["m"].version
        return [(deg.hist, deg.eps), (ups[-1].hist, ups[-1].eps)]
    finally:
        plane.close()
        reg.close()


def test_subs_eval_faultable(tmp_path):
    """An armed ``subs.eval`` turns the evaluation pass degraded; disarming
    heals to a fresh push."""
    _same(_subs_eval, tmp_path)


def _subs_deliver(pkg, root):
    reg, plane, sub = _plane_with_sub(pkg)
    try:
        rng = np.random.default_rng(2)
        with pkg.core.faults.inject("subs.deliver"):
            reg.ingest("m", 1, rng.normal(size=64))
            plane.flush()
            assert sub.drain() == []  # delivery faulted, nothing enqueued
            assert plane.deliver_failures >= 1
        batches = plane.stats()["eval_batches"]
        plane.flush()  # redelivery comes from the cache: no new dispatch
        assert plane.stats()["eval_batches"] == batches
        ups = sub.drain()
        assert ups and not ups[-1].degraded
        assert ups[-1].version == reg["m"].version
        return [(ups[-1].hist, ups[-1].eps)]
    finally:
        plane.close()
        reg.close()


def test_subs_deliver_faultable(tmp_path):
    """An armed ``subs.deliver`` loses no answers: the next pass after
    disarm re-delivers from the plane's answer cache, no new dispatch."""
    _same(_subs_deliver, tmp_path)


def _repl_pair(pkg, root):
    reg = _primary(pkg, root)
    standby = os.path.join(root, "standby")
    repl = pkg.repl.Replicator(
        reg._wal, [pkg.repl.DirTransport(standby)]
    ).attach(reg)
    return reg, repl, standby


def _repl_ship(pkg, root):
    reg, repl, standby = _repl_pair(pkg, root)
    rng = np.random.default_rng(0)
    faults = pkg.core.faults
    with faults.inject("repl.ship"):
        with pytest.raises(faults.FaultError):
            reg.ingest("m", 0, rng.normal(size=64).astype(np.float32))
        assert repl.stats()["ship_failures"] == 0  # faulted pre-lock
    reg.ingest("m", 1, rng.normal(size=64).astype(np.float32))
    f = _follower(pkg, standby)
    assert f.tail() == 2
    out = f.query_many([("m", 0, 1)], BETA)
    f.close()
    reg.close()
    return out


def test_repl_ship_faultable(tmp_path):
    """An armed ``repl.ship`` fails the ingest ack; the next ingest ships
    its record and the stranded one."""
    _same(_repl_ship, tmp_path)


def _repl_tail(pkg, root):
    reg, _repl, standby = _repl_pair(pkg, root)
    rng = np.random.default_rng(1)
    reg.ingest("m", 0, rng.normal(size=64).astype(np.float32))
    f = _follower(pkg, standby)
    faults = pkg.core.faults
    with faults.inject("repl.tail"):
        with pytest.raises(faults.FaultError):
            f.tail()
    assert f.stats()["records_applied"] == 0  # nothing half-applied
    assert f.tail() == 1  # healed on disarm
    out = f.query_many([("m", 0, 0)], BETA)
    f.close()
    reg.close()
    return out


def test_repl_tail_faultable(tmp_path):
    _same(_repl_tail, tmp_path)


def _repl_apply(pkg, root):
    reg, _repl, standby = _repl_pair(pkg, root)
    rng = np.random.default_rng(2)
    for pid in range(3):
        reg.ingest("m", pid, rng.normal(size=64).astype(np.float32))
    f = _follower(pkg, standby)
    faults = pkg.core.faults
    with faults.inject("repl.apply"):
        with pytest.raises(faults.FaultError):
            f.tail()
    st = f.stats()
    assert st["apply_failures"] == 1 and st["applied_lsn"] == 0
    assert f.tail() == 3  # full re-scan, every record exactly once
    assert f.lag()["records"] == 0
    out = f.query_many([("m", 0, 2)], BETA)
    f.close()
    reg.close()
    return out


def test_repl_apply_faultable_idempotent_rescan(tmp_path):
    """A fault mid-apply commits NO scan state: the next tail re-scans the
    same bytes and the pid dedup keeps the replay exactly-once."""
    _same(_repl_apply, tmp_path)


def _repl_promote(pkg, root):
    reg, repl, standby = _repl_pair(pkg, root)
    rng = np.random.default_rng(3)
    reg.ingest("m", 0, rng.normal(size=64).astype(np.float32))
    f = _follower(pkg, standby)
    f.tail()
    faults = pkg.core.faults
    with faults.inject("repl.promote"):
        with pytest.raises(faults.FaultError):
            f.promote(fence=repl.fence)
    assert f.promoted_epoch is None  # faulted before any state change
    reg.ingest("m", 1, rng.normal(size=64).astype(np.float32))  # not fenced
    promoted = f.promote(fence=repl.fence)  # healed on disarm
    assert f.promoted_epoch == 1
    assert promoted["m"].version > 0
    out = promoted.query_many([("m", 0, 1)], BETA)
    f.close()
    reg.close()
    return out


def test_repl_promote_faultable(tmp_path):
    _same(_repl_promote, tmp_path)


# ------------------------------------------- chaos (one small fixed case)
N_CHAOS = 32


def _arm_repl_faults(faults, stack, seed):
    stack.enter_context(
        faults.inject(
            "wal.append", exc=OSError(28, "ENOSPC"), prob=0.06, seed=seed
        )
    )
    stack.enter_context(
        faults.inject(
            "wal.fsync", exc=OSError(5, "EIO"), prob=0.06, seed=seed + 1
        )
    )
    stack.enter_context(faults.inject("repl.ship", prob=0.10, seed=seed + 2))
    stack.enter_context(faults.inject("repl.tail", prob=0.15, seed=seed + 3))
    stack.enter_context(faults.inject("repl.apply", prob=0.15, seed=seed + 4))


@pytest.mark.parametrize("seed,n_tenants,n_ops", [(3, 2, 12), (11, 3, 14)])
def test_chaos_replication_bounded_staleness_and_zero_loss_failover(
    tmp_path, seed, n_tenants, n_ops
):
    """The port under the reference chaos case's fault schedule: bounded
    staleness under fire, then ``kill -9`` of the primary and a promote
    that holds every acked record, each partition bit-equal to a
    fault-free reference registry fed the same values."""
    rng = np.random.default_rng(seed)
    tenants = [f"t{i}" for i in range(n_tenants)]
    base = str(tmp_path)
    reg = _reg(PORT, wal_dir=os.path.join(base, "pwal"))
    standby = os.path.join(base, "standby")
    repl = C_repl.Replicator(reg._wal, [C_repl.DirTransport(standby)]).attach(reg)
    follower = _follower(PORT, standby)
    oracle: dict[tuple[str, int], np.ndarray] = {}
    must: set[tuple[str, int]] = set()
    next_pid = {t: 0 for t in tenants}
    observed = []

    def draw_item():
        t = tenants[int(rng.integers(0, n_tenants))]
        next_pid[t] += int(rng.integers(1, 3))
        v = rng.normal(size=N_CHAOS).astype(np.float32)
        oracle[(t, next_pid[t])] = v
        return t, next_pid[t], v

    with contextlib.ExitStack() as stack:
        _arm_repl_faults(C.faults, stack, seed)
        for _ in range(n_ops):
            op = rng.integers(0, 10)
            if op < 4:
                t, pid, v = draw_item()
                try:
                    reg.ingest(t, pid, v)
                    must.add((t, pid))
                except (C.faults.FaultError, OSError):
                    pass
            elif op < 6:
                t, pid, v = draw_item()
                try:
                    reg.ingest_async(t, pid, v)
                    must.add((t, pid))
                except (C.IngestBackpressure, C.faults.FaultError):
                    pass
            elif op < 8:
                try:
                    follower.tail()
                except C.faults.FaultError:
                    pass
            else:
                t = tenants[int(rng.integers(0, n_tenants))]
                hi = next_pid[t] + 1
                [ans] = follower.query_many([(t, 0, hi)], BETA)
                drift = follower.drift_by_tenant()
                have = (
                    set(follower.registry[t].ids())
                    if t in follower.registry
                    else set()
                )
                gap = sum(
                    N_CHAOS for (mt, pid) in must if mt == t and pid not in have
                )
                if drift is None:
                    assert ans.degraded
                else:
                    assert drift.get(t, 0) >= gap
                    if gap > 0:
                        assert ans.degraded
                if not ans.degraded:
                    observed.append((t, sorted(have), hi, ans))
    for t, ids, hi, (hist, eps) in observed:
        ref = R.TenantRegistry(num_buckets=T)
        if ids:
            ref.ingest_many(t, {p: oracle[(t, p)] for p in ids})
        [(wh, we)] = ref.query_many([(t, 0, hi)], BETA, strict=False)
        assert (hist is None) == (wh is None)
        if hist is not None:
            assert np.array_equal(hist.boundaries, np.asarray(wh.boundaries))
            assert np.array_equal(hist.sizes, np.asarray(wh.sizes))
            assert eps == we
        ref.close()
    old_wal = reg._wal
    fence = repl.fence
    del reg
    promoted = follower.promote(fence=fence)
    for t, pid in sorted(must):
        assert t in promoted and pid in promoted[t].summaries, (t, pid)
    for t in promoted.names():
        ids = promoted[t].ids()
        assert {(t, pid) for pid in ids} <= set(oracle)
        if not ids:
            continue
        ref = R.TenantRegistry(num_buckets=T)
        ref.ingest_many(t, {pid: oracle[(t, pid)] for pid in ids})
        _bitmatch(promoted, ref, [(t, min(ids), max(ids))])
        ref.close()
    with pytest.raises(C.PrimaryFenced):
        old_wal.append("t0", 10**6, np.zeros(N_CHAOS, dtype=np.float32))
    t, pid, v = draw_item()
    promoted.ingest(t, pid, v)
    assert pid in promoted[t].summaries
    old_wal.close()
    follower.close()


# --------------------------------------------------- across the packages
def _cross(primary, replica, tmp_path):
    """``primary``'s services ship to a standby that ``replica`` serves:
    a checkpoint first (so the standby bootstraps from the primary
    package's snapshot), drift while the replica lags, then a promote
    that fences the primary's log."""
    pdir, sdir = str(tmp_path / "primary"), str(tmp_path / "standby")
    rng = np.random.default_rng(31)
    acked = {}
    svc = _service(primary, pdir)
    svc.registry._wal.segment_bytes = 256  # rotate per record
    for pid in range(3):
        acked[pid] = _vals(rng)
        svc.record("m", pid, acked[pid])
    svc.checkpoint()
    svc.close()
    svc = _service(primary, pdir, replicate_to=(sdir,))
    for pid in range(3, 5):
        acked[pid] = _vals(rng)
        svc.record("m", pid, acked[pid])
    svc.record("n", 0, _vals(rng, 40))
    rep = _service(replica, sdir, role="replica")  # tails once at startup
    assert rep.follower.stats()["records_applied"] == 3 and rep.sync() == 0
    # a second follower of the primary's own package, on the same shipped
    # directory (the standby's wal/): same drift, same answers
    twin = primary.repl.Follower(
        os.path.join(sdir, "wal"), num_buckets=T, **primary.kw
    )
    twin.tail()
    qs = [("m", 0, 4), ("m", 1, 3), ("n", 0, 0)]
    a_rep, a_twin = rep.query_many(qs, BETA), twin.query_many(qs, BETA)
    want = svc.query_many(qs, BETA)
    assert _facts(a_rep) == _facts(a_twin)
    assert _facts([(h, e) for h, e in a_rep]) == _facts([(h, e) for h, e in want])
    assert not any(a.degraded for a in a_rep)
    assert rep.follower.drift_by_tenant() == twin.drift_by_tenant() == {"m": 0, "n": 0}
    acked[5] = _vals(rng, 50)
    svc.record("m", 5, acked[5])  # shipped, not yet tailed: drift 50
    assert rep.follower.drift_by_tenant() == twin.drift_by_tenant() == {"m": 50, "n": 0}
    s_rep, s_twin = rep.query_many(qs, BETA), twin.query_many(qs, BETA)
    assert _facts(s_rep) == _facts(s_twin)
    assert s_rep[0].degraded and s_rep[0].eps == a_rep[0].eps + 50
    twin.close()
    fence = svc.replicator.fence
    rep.promote(fence=fence)
    with pytest.raises(primary.core.PrimaryFenced):
        svc.record("m", 6, _vals(rng))
    rep.record("m", 6, _vals(rng))
    oracle = _reg(replica)
    oracle.ingest_many("m", acked)
    _bitmatch(oracle, rep.registry, [("m", 0, 5)])
    rep.close()
    oracle.close()
    svc.close()
    svc.registry._wal.close()


def test_reference_primary_ships_to_a_port_follower(tmp_path):
    _cross(REF, PORT, tmp_path)


def test_port_primary_ships_to_a_reference_follower(tmp_path):
    _cross(PORT, REF, tmp_path)
