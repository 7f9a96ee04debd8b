"""Port parity: ``repro_torch.serve.HistogramService`` and
``repro_torch.core.telemetry`` against the reference's.

Mirrors the service cases of ``tests/test_durability.py`` (recovery after
a kill, the hub's WAL pass-through), ``tests/test_faults.py`` (degraded
serving by default, snapshot salvage), ``tests/test_retention.py`` (the
hub forwards retention), the two ``TelemetryHub`` cases of
``tests/test_tenant.py`` and the straggler case of
``tests/test_trainer_serve.py``.  Each is one scenario run on the same
seeded NumPy inputs through the reference and through the port
(``device="cpu"``: the kernels' plain versions); the reference test's
assertions hold for both, and what the scenario returns — answers,
quantiles, flagged hosts and the merged cut — is held equal between them,
answers bit for bit.  Also: the port's entry points go to the card by
default, and ``timed`` waits only for the devices its result lives on.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.telemetry as R_tel
import repro.serve as RS
import repro_torch.core as C
import repro_torch.core.telemetry as C_tel
import repro_torch.serve as CS

if os.environ.get("REPRO_LOCK_WITNESS") == "1":
    # tests/conftest.py arms only the reference's witness
    from repro_torch.analysis import witness as _witness

    _witness.arm()

REF = SimpleNamespace(name="ref", core=R, tel=R_tel, serve=RS, kw={})
PORT = SimpleNamespace(
    name="port", core=C, tel=C_tel, serve=CS, kw={"device": "cpu"}
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


def _vals(rng, n=32):
    return rng.normal(size=n).astype(np.float32)


def _facts(x):
    """Comparable form: answers become their arrays' bits, ε and degraded
    flag; tensors and arrays their bits."""
    if isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "sizes"):
        return ("answer", _facts(x[0].boundaries), _facts(x[0].sizes),
                float(x[1]), bool(getattr(x, "degraded", False)))
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray) or type(x).__module__.startswith("jax"):
        a = np.asarray(x)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(x, (list, tuple)):
        return [_facts(v) for v in x]
    return x


def _same(scenario, *args):
    ref, port = scenario(REF, *args), scenario(PORT, *args)
    assert _facts(ref) == _facts(port)
    return port


def _assert_same_answer(a, b):
    (ha, ea), (hb, eb) = a, b
    assert np.array_equal(np.asarray(ha.boundaries), np.asarray(hb.boundaries))
    assert np.array_equal(np.asarray(ha.sizes), np.asarray(hb.sizes))
    assert ea == eb


# ------------------------------------------------ recovery-aware startup
def _recovers(pkg, root):
    rng = np.random.default_rng(16)
    data_dir = os.path.join(root, pkg.name)
    svc = pkg.serve.HistogramService(data_dir, num_buckets=T, **pkg.kw)
    assert svc.recovery["records_scanned"] == 0  # cold start
    for w in range(3):
        svc.record("latency_ms", w, _vals(rng, 64))
    before = svc.query_many([("latency_ms", 0, 2)], BETA)
    svc.checkpoint()
    svc.record("latency_ms", 3, _vals(rng, 64))  # acked after snapshot
    before += svc.query_many([("latency_ms", 0, 3)], BETA)
    del svc  # kill -9

    svc2 = pkg.serve.HistogramService(data_dir, num_buckets=T, **pkg.kw)
    assert svc2.recovery["replayed"] == 1  # just the uncovered suffix
    assert svc2.registry["latency_ms"].ids() == [0, 1, 2, 3]
    q = svc2.quantile("latency_ms", 0, 3, 0.95)
    assert np.isfinite(float(np.asarray(q)))
    assert svc2.wal_stats()["depth"] == 0
    after = svc2.query_many([("latency_ms", 0, 2), ("latency_ms", 0, 3)], BETA)
    for a, b in zip(before, after):
        _assert_same_answer(a, b)  # the recovered service answers as before
    svc2.close()
    return [float(np.asarray(q))] + after


def test_histogram_service_recovers_after_kill(tmp_path):
    _same(_recovers, str(tmp_path))


def _hub_wal(pkg, root):
    hub = pkg.core.TelemetryHub(
        T=T, wal_dir=os.path.join(root, pkg.name, "wal"), **pkg.kw
    )
    hub.record("m", 0, np.ones(16, np.float32))
    stats = hub.wal_stats()
    assert stats is not None and stats["appends"] == 1
    out = hub.dashboard([("m", 0, 0)], BETA)
    hub.close()
    with pytest.raises(ValueError):
        pkg.core.TelemetryHub(
            T=T,
            registry=pkg.core.TenantRegistry(num_buckets=T, **pkg.kw),
            wal_dir=os.path.join(root, pkg.name, "wal2"),
        )
    return out


def test_telemetry_hub_wal_passthrough(tmp_path):
    _same(_hub_wal, str(tmp_path))


# ------------------------------------------------------ degraded serving
def _degraded(pkg, root):
    rng = np.random.default_rng(4)
    svc = pkg.serve.HistogramService(
        os.path.join(root, pkg.name), num_buckets=T, **pkg.kw
    )
    svc.record("latency", 0, _vals(rng, 64))
    svc.record("latency", 1, _vals(rng, 64))
    [fresh] = svc.query_many([("latency", 0, 1)], beta=BETA)
    with pkg.core.faults.inject("tenant.merge"):
        svc.record("latency", 2, _vals(rng, 16))
        [ans] = svc.query_many([("latency", 0, 2)], beta=BETA)
    assert ans.degraded  # the service plane degrades instead of raising
    assert svc.health()["degraded_served"] == 1
    svc.close()
    return [fresh, ans]


def test_service_query_many_defaults_degraded_ok(tmp_path):
    """Degraded answers (last-known-good, ε widened by the 16 values
    added since) bit-equal to the reference's."""
    _same(_degraded, str(tmp_path))


def _salvage(pkg, root):
    rng = np.random.default_rng(8)
    data_dir = os.path.join(root, pkg.name)
    svc = pkg.serve.HistogramService(data_dir, num_buckets=T, **pkg.kw)
    data = {pid: _vals(rng, 64) for pid in range(4)}
    for pid, v in data.items():
        svc.record("m", pid, v)
    svc.checkpoint()
    for pid in (4, 5):  # acked after the checkpoint: live only in the WAL
        data[pid] = _vals(rng, 64)
        svc.record("m", pid, data[pid])
    svc.close()
    snap = os.path.join(data_dir, "registry.npz")
    with open(snap, "r+b") as f:
        f.seek(os.path.getsize(snap) // 2)
        f.write(b"\xde\xad\xbe\xef")

    svc2 = pkg.serve.HistogramService(data_dir, num_buckets=T, **pkg.kw)
    assert svc2.salvage is not None and not svc2.salvage["ok"]
    assert os.path.exists(snap + ".corrupt")  # quarantined, not deleted
    present = set(svc2.registry["m"].ids()) if "m" in svc2.registry else set()
    assert {4, 5} <= present
    replica = pkg.core.TenantRegistry(num_buckets=T, **pkg.kw)
    replica.ingest_many("m", {pid: data[pid] for pid in sorted(present)})
    lo, hi = min(present), max(present)
    got = svc2.query_many([("m", lo, hi)], beta=BETA)
    _assert_same_answer(got[0], replica.query_many([("m", lo, hi)], BETA)[0])
    svc2.close()
    replica.close()
    return [sorted(present)] + got


def test_recover_salvage_rebuilds_from_wal_when_snapshot_rots(tmp_path):
    _same(_salvage, str(tmp_path))


# ------------------------------------------------------------ telemetry
def _hub_retention(pkg):
    hub = pkg.core.TelemetryHub(
        T=32, retention=pkg.core.SlidingWindow(2), **pkg.kw
    )
    rng = np.random.default_rng(21)
    for step in range(5):
        hub.record("loss", step, np.abs(rng.normal(size=64)).astype(np.float32))
    assert hub.registry["loss"].ids() == [3, 4]
    out = hub.dashboard([("loss", 3, 4)], 8)
    hub.close()
    explicit = pkg.core.TenantRegistry(num_buckets=32, **pkg.kw)
    with pytest.raises(ValueError):
        pkg.core.TelemetryHub(T=32, registry=explicit, retention=pkg.core.TTL(1))
    with pytest.raises(ValueError):
        pkg.core.TelemetryHub(T=32, registry=explicit, budget=10)
    explicit.close()
    return out


def test_telemetry_hub_forwards_retention():
    _same(_hub_retention)


def _hub_metrics(pkg):
    hub = pkg.core.TelemetryHub(T=64, **pkg.kw)
    rng = np.random.default_rng(0)
    truth = {}
    for metric in ("step_time", "grad_norm", "latency"):
        vals = []
        for step in range(4):
            v = np.abs(rng.normal(size=300)).astype(np.float32)
            hub.record(metric, step, v)
            vals.append(v)
        truth[metric] = np.concatenate(vals)
    assert hub.metrics() == ["grad_norm", "latency", "step_time"]
    qs = []
    for metric, pooled in truth.items():
        got = float(hub.quantile(metric, 0, 3, 0.95))
        true = float(np.quantile(pooled, 0.95))
        assert abs(got - true) <= np.ptp(pooled) * 0.1
        qs.append(got)
    panels = [(m, 0, 3) for m in hub.metrics()] + [("missing", 0, 3)]
    hub.registry.merge_dispatches = 0
    res = hub.dashboard(panels, beta=8)
    assert hub.registry.merge_dispatches <= 1
    assert res[-1] == (None, float("inf"))
    for h, _ in res[:-1]:
        assert float(np.asarray(h.sizes).sum()) == 4 * 300
    hub.close()
    return [qs] + res[:-1]


def test_telemetry_hub_tracks_many_metrics():
    _same(_hub_metrics)


def _hub_async(pkg):
    hub = pkg.core.TelemetryHub(T=32, async_record=True, **pkg.kw)
    rng = np.random.default_rng(1)
    for step in range(3):
        hub.record("loss", step, np.abs(rng.normal(size=200)).astype(np.float32))
    hub.flush()
    h, eps = hub.registry.query("loss", 0, 2, 8)
    assert float(np.asarray(h.sizes).sum()) == 3 * 200
    hub.close()
    return [(h, eps)]


def test_telemetry_hub_async_record():
    _same(_hub_async)


def _straggler(pkg):
    det = pkg.tel.StragglerDetector(
        window=32, T=32, quantile_q=0.5, tolerance=1.3, **pkg.kw
    )
    rng = np.random.default_rng(0)
    for step in range(32):
        for host in range(8):
            base = 0.10 + 0.005 * rng.standard_normal()
            det.record(host, base * (3.0 if host == 5 else 1.0))
    flagged, cut = det.flag()
    assert flagged == [5]
    assert 0.1 < cut < 0.35
    return [flagged, cut]


def test_straggler_detector_flags_slow_host():
    """Same flagged hosts and the same merged cut, bit for bit."""
    _same(_straggler)


def _straggler_ragged(pkg):
    """Hosts with 4 to 40 recent step times: summaries of different T,
    padded to T_max by repeating the last boundary with zero sizes."""
    det = pkg.tel.StragglerDetector(window=40, T=16, **pkg.kw)
    rng = np.random.default_rng(3)
    for host, n in enumerate((4, 9, 16, 40, 23, 3)):
        for _ in range(n):
            det.record(host, 0.2 + 0.01 * rng.standard_normal() + 0.3 * (host == 2))
    return list(det.flag())


def test_straggler_detector_pads_ragged_hosts_as_the_reference():
    flagged, cut = _same(_straggler_ragged)
    assert flagged == [2] and np.isfinite(cut)


def test_telemetry_log_matches_reference():
    h = C.build_exact(np.arange(40, dtype=np.float32), 4, device="cpu")
    logs = []
    for tel in (R_tel, C_tel):
        log = tel.TelemetryLog(capacity=3)
        for step in range(5):
            log.log_scalar("loss", step, 1.0 / (step + 1))
        log.log_histogram("w", 7, h)
        logs.append(log)
    ref, port = logs
    assert port.scalars == ref.scalars and port.last("loss") == 0.2
    for key in ("boundaries", "sizes"):
        a, b = ref.snapshots["w@7"][key], port.snapshots["w@7"][key]
        assert isinstance(b, np.ndarray) and np.array_equal(a, b)


# ------------------------------------------------------- device defaults
def test_entry_points_go_to_the_card_by_default(tmp_path, monkeypatch):
    """Without ``device``, the service, hub, follower and detector run on
    the card — and so raise where there is none, never falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CS.HistogramService(str(tmp_path / "svc"), num_buckets=T)
    with pytest.raises(RuntimeError, match="CUDA"):
        CS.HistogramService(str(tmp_path / "rep"), role="replica", num_buckets=T)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.TelemetryHub(T=T)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.Follower(str(tmp_path / "f"), num_buckets=T)
    det = C_tel.StragglerDetector()
    for host in range(2):
        for _ in range(4):
            det.record(host, 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        det.flag()


def test_timed_waits_only_for_the_results_devices(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    out, secs = C_tel.timed(lambda x: (x * 2, {"n": [x.sum()]}))(torch.ones(4))
    assert calls == [] and secs >= 0.0  # a host result waits for no device
    assert torch.equal(out[0], torch.full((4,), 2.0))
    found = C_tel._cuda_devices((torch.ones(1), {"a": [torch.ones(1)]}), set())
    assert found == set()
