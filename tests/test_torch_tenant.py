"""Port parity: ``repro_torch``'s ``TenantRegistry`` against ``repro``'s.

Mirrors ``tests/test_tenant.py`` (its two ``TelemetryHub`` tests are in
``tests/test_torch_service.py``) and the ``TenantRegistry`` cases of
``tests/test_faults.py``, ``tests/test_resilience.py`` and
``tests/test_chaos_props.py``.  Each builds the reference registry and the
port's from the same seeded NumPy partitions and holds every answer and ε
bit-equal between them.  Also: npz files crossing between the packages in
both directions, ``convert.registry_from_reference``, a reference-written
WAL recovered by the port, and retention/budget eviction.  The port runs
on the CPU here (``device="cpu"``: the kernels' plain versions).
"""
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import pytest

import repro.core as R
from repro_torch import convert
from repro_torch.core import (
    BreakerPolicy,
    HistogramStore,
    IngestBackpressure,
    RetryPolicy,
    SlidingWindow,
    TenantQuarantined,
    TenantRegistry,
    faults,
    scrub_store,
    verify_snapshot,
)
from repro_torch.core.workers import PartialBatchFailure

if os.environ.get("REPRO_LOCK_WITNESS") == "1":
    # tests/conftest.py arms only the reference's witness
    from repro_torch.analysis import witness as _witness

    _witness.arm()

T = 32
BETA = 8
N_PER = 256
PARTS = 6
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    R.faults.reset()
    yield
    faults.reset()
    R.faults.reset()


def _parts(seed, n_parts=PARTS, n=N_PER):
    rng = np.random.default_rng(seed)
    return {d: rng.gumbel(size=n).astype(np.float32) for d in range(n_parts)}


def _pair(n_tenants=6, **kw):
    """The reference registry and the port's, fed the same partitions."""
    ref = R.TenantRegistry(num_buckets=kw.pop("num_buckets", T), **kw)
    port = TenantRegistry(num_buckets=ref.num_buckets, **CPU, **kw)
    for t in range(n_tenants):
        for reg in (ref, port):
            reg.ingest_many(f"svc{t}", _parts(seed=t))
    return ref, port


def assert_same_answer(ra, pa):
    (hr, er), (hp, ep) = ra, pa
    assert (hr is None) == (hp is None)
    if hr is not None:
        br, bp = np.asarray(hr.boundaries), np.asarray(hp.boundaries)
        sr, sp = np.asarray(hr.sizes), np.asarray(hp.sizes)
        assert br.dtype == bp.dtype and np.array_equal(br, bp)
        assert sr.dtype == sp.dtype and np.array_equal(sr, sp)
    assert er == ep


def assert_same_answers(ras, pas):
    ras, pas = list(ras), list(pas)
    assert len(ras) == len(pas)
    for ra, pa in zip(ras, pas):
        assert_same_answer(ra, pa)


def all_windows(reg, names=None, n_parts=PARTS):
    return [(n, lo, hi) for n in (names or reg.names()) for lo in range(n_parts) for hi in range(lo, n_parts)]


# ------------------------------------------------------------ tenant admin
def test_tenant_get_or_create_shares_config():
    reg = TenantRegistry(num_buckets=T, T_node="geometric", cache_size=7, **CPU)
    s1 = reg.tenant("a")
    assert reg.tenant("a") is s1
    assert (s1.num_buckets, s1.T_node, s1.cache_size) == (T, "geometric", 7)
    assert not s1.async_ingest and str(s1.device) == "cpu"
    assert "a" in reg and "b" not in reg
    with pytest.raises(KeyError):
        reg["b"]
    assert len(reg) == 1 and reg.names() == ["a"]
    assert reg._replication is None and reg._stale_listeners == []  # nothing attached


def test_tenant_names_are_str_normalized():
    ref, port = R.TenantRegistry(num_buckets=T), TenantRegistry(num_buckets=T, **CPU)
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=100).astype(np.float32) for _ in range(3)]
    for reg in (ref, port):
        reg.ingest(5, 0, vals[0])
        reg.ingest(5, 1, vals[1])
        assert reg["5"].ids() == [0, 1] and reg[5] is reg["5"] and len(reg) == 1
        reg.ingest_async(5, 2, vals[2])
        reg.flush()
    assert_same_answer(ref.query(5, 0, 1, BETA), port.query(5, 0, 1, BETA))
    assert_same_answers(ref.query_many([(5, 0, 2)], BETA), port.query_many([(5, 0, 2)], BETA))
    for reg in (ref, port):
        reg.close()


# ------------------------------------------- cross-tenant batched queries
@pytest.mark.parametrize("shared_arena", [False, True])
def test_query_many_bit_equal_to_reference_and_per_store(shared_arena):
    ref, port = _pair(6, shared_arena=shared_arena)
    rng = np.random.default_rng(99)
    qs = []
    for name in port.names():
        lo = int(rng.integers(0, PARTS))
        qs.append((name, lo, int(rng.integers(lo, PARTS))))
    qs += [qs[0], ("svc3", 0, PARTS - 1)]
    got = port.query_many(qs, BETA)
    assert_same_answers(ref.query_many(qs, BETA), got)
    for (name, lo, hi), pa in zip(qs, got):
        assert_same_answer(port[name].query(lo, hi, BETA), pa)
    assert_same_answers(ref.query_many(all_windows(ref), BETA), port.query_many(all_windows(port), BETA))


@pytest.mark.parametrize("shared_arena", [False, True])
def test_query_many_is_one_dispatch_and_caches(shared_arena):
    ref, port = _pair(5, shared_arena=shared_arena)
    qs = [(name, 0, PARTS - 1) for name in port.names()]
    for reg in (ref, port):
        reg.merge_dispatches = 0
        reg.reset_host_row_copies()
    res = port.query_many(qs, BETA)
    ref_res = ref.query_many(qs, BETA)
    assert port.merge_dispatches == ref.merge_dispatches == 1
    assert port.merge_shapes == ref.merge_shapes
    assert port.host_row_copies == ref.host_row_copies
    if shared_arena:
        assert port.host_row_copies == 0 and port.pack_fallbacks == 0
    assert_same_answers(ref_res, res)
    res2 = port.query_many(qs, BETA)
    assert port.merge_dispatches == 1  # warm repeat from the per-tenant LRUs
    assert_same_answers(res, res2)
    hits0 = port["svc0"]._tree.cache_hits
    port["svc0"].query(0, PARTS - 1, BETA)
    assert port["svc0"]._tree.cache_hits == hits0 + 1
    assert port.cache_stats()["merge_dispatches"] == 1


def test_query_many_mixed_hit_miss_single_dispatch():
    ref, port = _pair(4)
    for reg in (ref, port):
        reg.query_many([("svc0", 0, 2), ("svc1", 1, 3)], BETA)
    d0 = port.merge_dispatches
    qs = [("svc0", 0, 2), ("svc2", 0, 1), ("svc1", 1, 3), ("svc3", 2, 4)]
    res = port.query_many(qs, BETA)
    assert port.merge_dispatches == d0 + 1
    assert_same_answers(ref.query_many(qs, BETA), res)


def test_query_many_strict_false_placeholders_keep_indexing_stable():
    ref, port = _pair(3)
    qs = [("svc0", 0, PARTS - 1), ("ghost", 0, 3), ("svc1", 2, 2), ("svc2", 0, 0)]
    for reg in (ref, port):
        del reg["svc1"].summaries[2]
    res = port.query_many(qs, BETA, strict=False)
    assert res[1] == (None, float("inf")) and res[2] == (None, float("inf"))
    assert float(res[0][0].sizes.sum()) == PARTS * N_PER
    assert_same_answers(ref.query_many(qs, BETA, strict=False), res)
    with pytest.raises(KeyError):
        port.query_many(qs, BETA, strict=True)
    with pytest.raises(KeyError):
        port.query_many([("svc1", 0, PARTS - 1)], BETA)


@pytest.mark.parametrize("shared_arena", [False, True])
def test_query_many_geometric_tnode_mixed_node_resolutions(shared_arena):
    ref = R.TenantRegistry(num_buckets=T, T_node="geometric", shared_arena=shared_arena)
    port = TenantRegistry(num_buckets=T, T_node="geometric", shared_arena=shared_arena, **CPU)
    for t in range(3):
        for reg in (ref, port):
            reg.ingest_many(f"m{t}", _parts(seed=10 + t, n_parts=8))
    qs = [(f"m{t}", 0, 7) for t in range(3)] + [("m1", 2, 5)]
    res = port.query_many(qs, BETA)
    assert_same_answers(ref.query_many(qs, BETA), res)
    assert port.pack_fallbacks == ref.pack_fallbacks  # mixed planes: host pack
    for (name, lo, hi), pa in zip(qs, res):
        assert_same_answer(port[name].query(lo, hi, BETA), pa)


# ---------------------------------------------------- shared async ingest
@pytest.mark.parametrize("shared_arena", [False, True])
def test_async_pool_fans_in_many_tenants(shared_arena):
    ref = R.TenantRegistry(num_buckets=T, workers=3, shared_arena=shared_arena)
    port = TenantRegistry(num_buckets=T, workers=3, shared_arena=shared_arena, **CPU)
    want = {f"w{t}": _parts(seed=20 + t, n_parts=4) for t in range(8)}
    for reg in (ref, port):
        for name, parts in want.items():
            for d, v in parts.items():
                reg.ingest_async(name, d, v)
        reg.flush()
    qs = all_windows(port, sorted(want), n_parts=4)
    assert_same_answers(ref.query_many(qs, BETA), port.query_many(qs, BETA))
    for name, parts in want.items():
        sync = HistogramStore(num_buckets=T, **CPU)
        sync.ingest_many(parts)
        assert_same_answer(sync.query(0, 3, BETA), port.query(name, 0, 3, BETA))
    for reg in (ref, port):
        reg.close()


def test_shared_arena_batched_apply_pulls_up_all_tenants_together():
    """One drained batch across many tenants: the shared-arena apply pulls
    up every touched tree with one merge per level (``pull_up_trees``),
    and the answers equal the reference's and a per-tenant registry's."""
    port = TenantRegistry(num_buckets=T, shared_arena=True, **CPU)
    ref = R.TenantRegistry(num_buckets=T, shared_arena=True)
    alone = TenantRegistry(num_buckets=T, **CPU)
    batch = [(f"b{t}", d, v) for t in range(5) for d, v in _parts(seed=40 + t, n_parts=7).items()]
    port._apply_worker_batch(batch)
    ref._apply_worker_batch(batch)
    for name, d, v in batch:
        alone.ingest(name, d, v)
    qs = all_windows(port, n_parts=7)
    assert_same_answers(ref.query_many(qs, BETA), port.query_many(qs, BETA))
    assert_same_answers(alone.query_many(qs, BETA), port.query_many(qs, BETA))


def test_async_pool_validates_synchronously_and_isolates_poison():
    reg = TenantRegistry(num_buckets=T, **CPU)
    with pytest.raises(ValueError):
        reg.ingest_async("a", 0, np.asarray([], np.float32))
    parts = _parts(seed=5, n_parts=4)
    store = reg.tenant("a")
    orig = store._summarize_batch

    def failing(batch):
        if 2 in batch:
            raise RuntimeError("boom at pid 2")
        return orig(batch)

    store._summarize_batch = failing
    for d, v in parts.items():
        reg.ingest_async("a", d, v)
    for d, v in _parts(seed=6, n_parts=4).items():
        reg.ingest_async("b", d, v)
    with pytest.raises(RuntimeError) as ei:
        reg.flush()
    assert "tenant 'a' partition 2" in str(ei.value)
    assert sorted(store.ids()) == [0, 1, 3]
    assert sorted(reg["b"].ids()) == [0, 1, 2, 3]
    store._summarize_batch = orig
    reg.ingest_async("a", 2, parts[2])
    reg.flush()
    assert sorted(store.ids()) == [0, 1, 2, 3]
    reg.close()


def test_async_pool_error_appends_hold_the_flush_lock():
    reg = TenantRegistry(num_buckets=T, **CPU)
    reg._cv = threading.Condition(threading.Lock())  # non-reentrant
    unlocked = []

    class Guarded(list):
        def append(self, item):
            if reg._cv._lock.acquire(blocking=False):
                reg._cv._lock.release()
                unlocked.append(item)
            super().append(item)

    reg._errors = Guarded()
    store = reg.tenant("a")
    store._summarize_batch = lambda parts: (_ for _ in ()).throw(RuntimeError("boom"))
    rng = np.random.default_rng(0)
    for d in range(3):
        reg.ingest_async("a", d, rng.normal(size=16).astype(np.float32))
    with pytest.raises(RuntimeError):
        reg.flush()
    assert unlocked == []
    reg.close()


@pytest.mark.parametrize("shared_arena", [False, True])
def test_poison_narrows_retry_to_the_failing_tenants_group(shared_arena):
    reg = TenantRegistry(num_buckets=T, shared_arena=shared_arena, **CPU)
    a, b = reg.tenant("a"), reg.tenant("b")
    a._summarize_batch = lambda parts: (_ for _ in ()).throw(RuntimeError("boom"))
    rng = np.random.default_rng(0)
    batch = [
        ("a", 0, rng.normal(size=64).astype(np.float32)),
        ("b", 0, rng.normal(size=64).astype(np.float32)),
        ("b", 1, rng.normal(size=64).astype(np.float32)),
    ]
    with pytest.raises(PartialBatchFailure) as ei:
        reg._apply_worker_batch(batch)
    assert [(t, pid) for t, pid, _ in ei.value.items] == [("a", 0)]
    assert b.ids() == [0, 1]
    with pytest.raises(RuntimeError, match="boom"):
        reg._apply_worker_batch([batch[0]])


def test_close_drains_and_pool_restarts():
    reg = TenantRegistry(num_buckets=T, workers=2, **CPU)
    parts = _parts(seed=7, n_parts=4)
    for d, v in parts.items():
        reg.ingest_async("a", d, v)
    reg.close()
    assert sorted(reg["a"].ids()) == [0, 1, 2, 3]
    reg.ingest_async("b", 0, parts[0])
    reg.flush()
    assert reg["b"].ids() == [0]
    reg.close()


# ------------------------------------------------------------ persistence
@pytest.mark.parametrize("shared_arena", [False, True])
def test_registry_roundtrip_one_npz(tmp_path, shared_arena):
    _, port = _pair(4, T_node="geometric", shared_arena=shared_arena)
    path = str(tmp_path / "registry.npz")
    for _ in range(2):
        port.save(path)
    assert sorted(os.listdir(tmp_path)) == ["registry.npz"]
    loaded = TenantRegistry.load(path, device="cpu")
    assert loaded.names() == port.names() and loaded.T_node == "geometric"
    assert (loaded.arena is None) == (not shared_arena)
    for name in port.names():
        assert loaded[name]._tree.nodes.keys() == port[name]._tree.nodes.keys()
    qs = [(n, 1, 4) for n in port.names()]
    assert_same_answers(port.query_many(qs, BETA), loaded.query_many(qs, BETA))


def test_registry_load_rejects_store_files(tmp_path):
    store = HistogramStore(num_buckets=T, **CPU)
    store.ingest_many(_parts(seed=1, n_parts=3))
    path = str(tmp_path / "store.npz")
    store.save(path)
    with pytest.raises(ValueError):
        TenantRegistry.load(path, device="cpu")


@pytest.mark.parametrize("shared_arena", [False, True])
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_npz_saved_by_one_package_loads_in_the_other(tmp_path, direction, shared_arena):
    ref, port = _pair(4, T_node="geometric", shared_arena=shared_arena, retention=None)
    path = str(tmp_path / "registry.npz")
    if direction == "reference_to_port":
        ref.save(path)
        loaded, other = TenantRegistry.load(path, device="cpu"), ref
    else:
        port.save(path)
        loaded, other = R.TenantRegistry.load(path), port
    assert loaded.names() == other.names() and loaded.T_node == "geometric"
    qs = all_windows(other)
    assert_same_answers(other.query_many(qs, BETA), loaded.query_many(qs, BETA))


@pytest.mark.parametrize("shared_arena", [False, True])
def test_registry_from_reference(tmp_path, shared_arena):
    ref, _ = _pair(3, shared_arena=shared_arena, budget=10**9)
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    with np.load(path) as data:
        meta = json.loads(str(data["meta"]))
        arrays = {k: data[k] for k in data.files if k != "meta"}
    port = convert.registry_from_reference(meta, arrays, device="cpu")
    assert port.names() == ref.names() and port.budget == 10**9
    for name in ref.names():  # pre-merged nodes carried, not re-merged
        assert port[name]._tree.nodes.keys() == ref[name]._tree.nodes.keys()
        for key, nd in ref[name]._tree.nodes.items():
            assert np.array_equal(nd.boundaries, port[name]._tree.nodes[key].boundaries)
            assert nd.eps == port[name]._tree.nodes[key].eps
    qs = all_windows(ref)
    assert_same_answers(ref.query_many(qs, BETA), port.query_many(qs, BETA))


# ------------------------------------------------- retention and budgets
def test_retention_and_budget_evict_as_the_reference():
    ref = R.TenantRegistry(num_buckets=T, retention=R.SlidingWindow(4), budget=4000)
    port = TenantRegistry(num_buckets=T, retention=SlidingWindow(4), budget=4000, **CPU)
    for t, n_parts in enumerate([9, 3, 6]):
        for reg in (ref, port):
            reg.ingest_many(f"r{t}", _parts(seed=60 + t, n_parts=n_parts))
    for name in ref.names():
        assert port[name].ids() == ref[name].ids() and port[name].watermark == ref[name].watermark
    assert port.node_floats() == ref.node_floats()
    assert sum(port.node_floats().values()) <= 4000
    port.budget = ref.budget = 1500
    assert port.enforce_budget() == ref.enforce_budget()
    qs = [(n, min(port[n].ids()), max(port[n].ids())) for n in port.names()]
    assert_same_answers(ref.query_many(qs, BETA), port.query_many(qs, BETA))


# --------------------------------------------------------- durable ingest
def test_wal_recovers_acked_async_ingest(tmp_path):
    wal_dir, snap = str(tmp_path / "wal"), str(tmp_path / "reg.npz")
    port = TenantRegistry(num_buckets=T, wal_dir=wal_dir, **CPU)
    parts = {f"d{t}": _parts(seed=70 + t, n_parts=4) for t in range(3)}
    port.ingest_many("d0", parts["d0"])
    port.save(snap)
    for name in ("d1", "d2"):
        for d, v in parts[name].items():
            port.ingest_async(name, d, v)  # acked: logged + fsynced
    port._wal.close()
    del port  # crash: no flush, no close
    rec = TenantRegistry.recover(snap, wal_dir, num_buckets=T, **CPU)
    ref = R.TenantRegistry(num_buckets=T)
    for name, p in parts.items():
        ref.ingest_many(name, p)
    qs = all_windows(ref, n_parts=4)
    assert_same_answers(ref.query_many(qs, BETA), rec.query_many(qs, BETA))
    assert rec.last_recovery["replayed"] == 8
    rec.close()


def test_port_recovers_reference_written_registry_wal(tmp_path):
    wal_dir = str(tmp_path / "wal")
    ref = R.TenantRegistry(num_buckets=T, wal_dir=wal_dir)
    parts = {f"x{t}": _parts(seed=80 + t, n_parts=3) for t in range(2)}
    for name, p in parts.items():
        for d, v in p.items():
            ref.ingest(name, d, v)
    ref.close()
    ref._wal.close()
    rec = TenantRegistry.recover(str(tmp_path / "none.npz"), wal_dir, num_buckets=T, **CPU)
    assert rec.last_recovery["replayed"] == 6 and rec.wal_stats() is not None
    qs = all_windows(ref, n_parts=3)
    assert_same_answers(ref.query_many(qs, BETA), rec.query_many(qs, BETA))
    rec.close()


def test_health_has_the_reference_shape():
    ref, port = _pair(2)
    hr, hp = ref.health(), port.health()
    assert hr.keys() == hp.keys() and hp["status"] == hr["status"] == "ok"
    assert hp["subscriptions"] is None and hp["replication"] is None
    # the port's pool also reports the mean queue wait (IngestPool.stats)
    assert hp["pool"].keys() == hr["pool"].keys() | {"queue_wait_ms_mean"}


# --------------------------------------------- circuit breakers (faults)
FT, FBETA = 8, 16


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _vals(rng, n=32):
    return rng.normal(size=n).astype(np.float32)


def _breaker_registry(threshold=2, cooldown=10.0):
    clock = FakeClock()
    reg = TenantRegistry(
        num_buckets=FT,
        breaker=BreakerPolicy(threshold=threshold, cooldown=cooldown, probes=1, clock=clock),
        **CPU,
    )
    return reg, clock


def test_breaker_quarantines_failing_tenant_and_probes_back():
    rng = np.random.default_rng(0)
    reg, clock = _breaker_registry(threshold=2, cooldown=10.0)
    reg.ingest("ok", 0, _vals(rng))
    with faults.inject("tenant.apply", match=lambda ctx: ctx.get("tenant") == "bad"):
        for _ in range(2):
            with pytest.raises(faults.FaultError):
                reg.ingest("bad", 0, _vals(rng))
        with pytest.raises(TenantQuarantined):
            reg.ingest("bad", 1, _vals(rng))
        with pytest.raises(TenantQuarantined):
            reg.ingest_async("bad", 1, _vals(rng))
    reg.ingest("ok", 1, _vals(rng))
    health = reg.health()
    assert health["status"] == "degraded" and health["quarantined"] == ["bad"]
    assert health["breakers"]["bad"]["trips"] == 1
    clock.now = 9.0
    with pytest.raises(TenantQuarantined):
        reg.ingest("bad", 1, _vals(rng))
    clock.now = 10.0
    reg.ingest("bad", 1, _vals(rng))
    assert reg.health()["breakers"]["bad"]["state"] == "closed"
    assert reg.health()["status"] == "ok" and sorted(reg["bad"].ids()) == [1]
    reg.close()


def test_breaker_probe_failure_reopens():
    rng = np.random.default_rng(0)
    reg, clock = _breaker_registry(threshold=1, cooldown=5.0)
    with faults.inject("tenant.apply", match=lambda ctx: ctx.get("tenant") == "bad"):
        with pytest.raises(faults.FaultError):
            reg.ingest("bad", 0, _vals(rng))
        clock.now = 5.0
        with pytest.raises(faults.FaultError):
            reg.ingest("bad", 0, _vals(rng))
        with pytest.raises(TenantQuarantined):
            reg.ingest("bad", 0, _vals(rng))
    assert reg.health()["breakers"]["bad"]["trips"] == 2
    reg.close()


def test_async_terminal_failure_counts_against_breaker():
    rng = np.random.default_rng(0)
    reg, _clock = _breaker_registry(threshold=1)
    reg._pool.retry = RetryPolicy(attempts=2, base=0.0, jitter=0.0)
    with faults.inject("tenant.apply", match=lambda ctx: ctx.get("tenant") == "bad"):
        reg.ingest_async("bad", 0, _vals(rng))
        with pytest.raises(RuntimeError):
            reg.flush()
    assert reg.health()["quarantined"] == ["bad"]
    reg.close()


# ------------------------------------------------------ degraded serving
def _fresh_pair(rng, pids=range(4)):
    data = {pid: _vals(rng, 64) for pid in pids}
    ref, port = R.TenantRegistry(num_buckets=FT), TenantRegistry(num_buckets=FT, **CPU)
    for reg in (ref, port):
        reg.ingest_many("m", data)
    return ref, port


def test_degraded_answer_serves_last_good_with_widened_eps():
    rng = np.random.default_rng(0)
    ref, reg = _fresh_pair(rng)
    [primed] = reg.query_many([("m", 0, 4)], FBETA, strict=False, degraded_ok=True)
    assert not getattr(primed, "degraded", False)
    assert_same_answer(ref.query_many([("m", 0, 4)], FBETA, strict=False)[0], primed)
    reg.ingest("m", 4, _vals(rng, 50))
    with faults.inject("tenant.merge"):
        with pytest.raises(faults.FaultError):
            reg.query_many([("m", 0, 4)], FBETA)
        [ans] = reg.query_many([("m", 0, 4)], FBETA, strict=False, degraded_ok=True)
    assert ans.degraded
    h, eps = ans
    assert_same_answer((h, eps - 50), primed)
    assert reg.degraded_served == 1 and ans.stale_version is not None
    [healed] = reg.query_many([("m", 0, 4)], FBETA, strict=False, degraded_ok=True)
    assert not getattr(healed, "degraded", False)
    reg.close()


def test_degraded_widening_counts_removed_mass_too():
    rng = np.random.default_rng(1)
    _, reg = _fresh_pair(rng)
    [fresh] = reg.query_many([("m", 0, 3)], FBETA, degraded_ok=True)
    removed_mass = reg["m"].summaries[0].n
    reg["m"].evict([0])
    with faults.inject("tenant.merge"):
        [ans] = reg.query_many([("m", 0, 3)], FBETA, strict=False, degraded_ok=True)
    assert ans.degraded and ans[1] == fresh[1] + removed_mass
    reg.close()


def test_degraded_without_cached_answer_is_inf_placeholder():
    _, reg = _fresh_pair(np.random.default_rng(2))
    with faults.inject("tenant.merge"):
        [ans] = reg.query_many([("m", 0, 3)], FBETA, degraded_ok=True)
    assert ans.degraded and ans[0] is None and ans[1] == float("inf")
    reg.close()


def test_deadline_past_serves_degraded_without_dispatch():
    _, reg = _fresh_pair(np.random.default_rng(3))
    [fresh] = reg.query_many([("m", 0, 3)], FBETA, degraded_ok=True)
    reg["m"]._tree._invalidate()
    reg._clock = lambda: 100.0
    before = reg.merge_dispatches
    [ans] = reg.query_many([("m", 0, 3)], FBETA, degraded_ok=True, deadline=50.0)
    assert ans.degraded and reg.merge_dispatches == before
    assert_same_answer((ans[0], ans[1]), fresh)
    reg.close()


# ------------------------------------- integrity scrubber + snapshot salvage
def _rot_summary(store, pid):
    s = store.summaries[pid]
    bad = np.array(s.sizes)
    bad[0] += 1.0
    store.summaries[pid] = dataclasses.replace(s, sizes=bad)


def test_scrub_detects_in_memory_corruption_and_repairs_from_wal(tmp_path):
    rng = np.random.default_rng(5)
    reg = TenantRegistry(num_buckets=FT, wal_dir=str(tmp_path / "wal"), **CPU)
    data = {pid: _vals(rng, 64) for pid in range(3)}
    reg.ingest_many("m", data)
    assert reg.scrub() == {"tenants": 1, "checked": 3, "corrupt": {}, "repaired": {}, "dropped": {}}
    _rot_summary(reg["m"], 1)
    assert scrub_store(reg["m"])["corrupt"] == [1]
    rep = reg.scrub(repair=True)
    assert rep["corrupt"] == {"m": [1]} and rep["repaired"] == {"m": [1]} and rep["dropped"] == {}
    assert reg.health()["last_scrub"] is rep
    replica = R.TenantRegistry(num_buckets=FT)
    replica.ingest_many("m", data)
    assert_same_answer(replica.query_many([("m", 0, 2)], FBETA)[0], reg.query_many([("m", 0, 2)], FBETA)[0])
    reg.close()


def test_scrub_drops_partition_with_no_wal_record(tmp_path):
    rng = np.random.default_rng(6)
    reg = TenantRegistry(num_buckets=FT, wal_dir=str(tmp_path / "wal"), **CPU)
    reg.ingest_many("m", {pid: _vals(rng, 64) for pid in range(3)})
    reg.save(str(tmp_path / "reg.npz"))
    for p in list(reg._wal._segments):
        if os.path.exists(p):
            os.unlink(p)
    reg._wal._segments.clear()
    _rot_summary(reg["m"], 1)
    rep = reg.scrub(repair=True)
    assert rep["corrupt"] == {"m": [1]} and rep["dropped"] == {"m": [1]}
    assert sorted(reg["m"].ids()) == [0, 2]
    [(h, _eps)] = reg.query_many([("m", 0, 2)], FBETA, strict=False)
    assert h is not None
    reg.close()


def test_verify_snapshot_roundtrip_and_corruption(tmp_path):
    rng = np.random.default_rng(7)
    reg = TenantRegistry(num_buckets=FT, **CPU)
    reg.ingest_many("m", {pid: _vals(rng, 64) for pid in range(3)})
    path = str(tmp_path / "reg.npz")
    reg.save(path)
    rep = verify_snapshot(path)
    assert rep["ok"] and rep["checked"] > 0 and rep["bad_keys"] == []
    assert R.verify_snapshot(path)["ok"]  # the reference reads the port's checksums
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff\xff\xff\xff")
    assert not verify_snapshot(path)["ok"]
    reg.close()


def test_recover_salvage_rebuilds_from_wal_when_snapshot_rots(tmp_path):
    rng = np.random.default_rng(8)
    snap, wal_dir = str(tmp_path / "registry.npz"), str(tmp_path / "wal")
    reg = TenantRegistry(num_buckets=FT, wal_dir=wal_dir, **CPU)
    data = {pid: _vals(rng, 64) for pid in range(4)}
    for pid, v in data.items():
        reg.ingest("m", pid, v)
    reg.save(snap)
    for pid in (4, 5):
        data[pid] = _vals(rng, 64)
        reg.ingest("m", pid, data[pid])
    reg.close()
    reg._wal.close()
    with open(snap, "r+b") as f:
        f.seek(os.path.getsize(snap) // 2)
        f.write(b"\xde\xad\xbe\xef")
    rec = TenantRegistry.recover(snap, wal_dir, salvage=True, num_buckets=FT, **CPU)
    assert rec.last_salvage is not None and not rec.last_salvage["ok"]
    assert os.path.exists(snap + ".corrupt")
    present = set(rec["m"].ids()) if "m" in rec else set()
    assert {4, 5} <= present
    replica = R.TenantRegistry(num_buckets=FT)
    replica.ingest_many("m", {pid: data[pid] for pid in sorted(present)})
    lo, hi = min(present), max(present)
    assert_same_answer(replica.query_many([("m", lo, hi)], FBETA)[0], rec.query_many([("m", lo, hi)], FBETA)[0])
    rec.close()


def test_snapshot_save_corrupt_failpoint_is_caught_by_verify(tmp_path):
    reg = TenantRegistry(num_buckets=FT, **CPU)
    reg.ingest_many("m", {0: _vals(np.random.default_rng(9), 64)})
    path = str(tmp_path / "reg.npz")
    with faults.inject("snapshot.save.corrupt", action=lambda **ctx: 128):
        reg.save(path)
    assert not verify_snapshot(path)["ok"]
    reg.close()


def test_no_fd_or_thread_leak_across_crash_recover_cycles(tmp_path):
    rng = np.random.default_rng(10)
    data = {pid: _vals(rng, 32) for pid in range(2)}
    policy = BreakerPolicy(threshold=1, cooldown=1.0, clock=FakeClock())

    def cycle(i):
        d = str(tmp_path / "data")
        reg = TenantRegistry.recover(os.path.join(d, "reg.npz"), os.path.join(d, "wal"), num_buckets=FT, **CPU)
        reg.breaker_policy = policy
        reg.ingest_many("m", data)
        reg.ingest_async("m", 2 + i, _vals(rng, 16))
        with faults.inject("tenant.apply", match=lambda ctx: ctx.get("tenant") == "bad"):
            with pytest.raises(faults.FaultError):
                reg.ingest("bad", 0, _vals(rng, 16))
            with pytest.raises(TenantQuarantined):
                reg.ingest("bad", 1, _vals(rng, 16))
        reg.flush()
        reg.scrub()
        if i % 2 == 0:
            reg.save(os.path.join(d, "reg.npz"))
        reg.close()
        reg._wal.close()

    cycle(0)
    gc.collect()
    fd_before = len(os.listdir("/proc/self/fd"))
    threads_before = threading.active_count()
    for i in range(1, 21):
        cycle(i)
    gc.collect()
    assert threading.active_count() <= threads_before
    assert len(os.listdir("/proc/self/fd")) <= fd_before + 2


# ------------------------------------------------------------------ chaos
def _arm_faults(stack, seed):
    stack.enter_context(faults.inject("wal.append", exc=OSError(28, "ENOSPC"), prob=0.08, seed=seed))
    stack.enter_context(
        faults.inject("wal.append.torn", action=lambda **ctx: min(9, ctx.get("size", 9)), prob=0.06, seed=seed + 1)
    )
    stack.enter_context(faults.inject("wal.fsync", exc=OSError(5, "EIO"), prob=0.08, seed=seed + 2))
    stack.enter_context(faults.inject("pool.batch", prob=0.10, seed=seed + 3))
    stack.enter_context(faults.inject("tenant.apply", prob=0.08, seed=seed + 4))
    stack.enter_context(faults.inject("tenant.merge", prob=0.20, seed=seed + 5))


def _reference_answer(oracle, t, ids, lo, hi):
    ref = R.TenantRegistry(num_buckets=FT)
    ref.ingest_many(t, {pid: oracle[(t, pid)] for pid in ids})
    [ans] = ref.query_many([(t, lo, hi)], FBETA, strict=False)
    ref.close()
    return ans


@pytest.mark.parametrize("seed", [11, 2024, 77_777, 3_141_592])
def test_chaos_no_acked_loss_no_hangs_honest_answers(seed):
    """The registry part of the reference's chaos property (standing
    subscriptions and replication are not ported yet): random sync/async
    ingest, drains, checkpoints and queries under seeded WAL, pool, apply
    and merge faults, then a crash and a salvage recovery.  Every acked
    partition survives, nothing hangs, and every fresh answer bit-matches
    a fault-free *reference* registry fed the same partitions."""
    rng = np.random.default_rng(seed)
    n_tenants, n_ops = int(rng.integers(1, 4)), int(rng.integers(8, 15))
    tenants = [f"t{i}" for i in range(n_tenants)]
    base = tempfile.mkdtemp(prefix="chaos-")
    try:
        snap, wal_dir = os.path.join(base, "reg.npz"), os.path.join(base, "wal")
        reg = TenantRegistry(num_buckets=FT, wal_dir=wal_dir, **CPU)
        oracle: dict[tuple[str, int], np.ndarray] = {}
        must: set[tuple[str, int]] = set()
        next_pid = {t: 0 for t in tenants}

        def draw_item():
            t = tenants[int(rng.integers(0, n_tenants))]
            next_pid[t] += int(rng.integers(1, 3))
            v = rng.normal(size=32).astype(np.float32)
            oracle[(t, next_pid[t])] = v
            return t, next_pid[t], v

        with contextlib.ExitStack() as stack:
            _arm_faults(stack, seed)
            for _ in range(n_ops):
                op = rng.integers(0, 10)
                if op < 4:
                    t, pid, v = draw_item()
                    try:
                        reg.ingest(t, pid, v)
                        must.add((t, pid))
                    except (faults.FaultError, OSError):
                        pass
                elif op < 7:
                    t, pid, v = draw_item()
                    try:
                        reg.ingest_async(t, pid, v)
                        must.add((t, pid))
                    except IngestBackpressure:
                        pass
                elif op < 8:
                    for t, pid, _e in reg._pool.drain():
                        must.discard((t, pid))
                elif op < 9:
                    for t, pid, _e in reg._pool.drain():
                        must.discard((t, pid))
                    reg.save(snap)
                else:
                    for t in tenants:
                        if t in reg and reg[t].ids():
                            ids = reg[t].ids()
                            [ans] = reg.query_many([(t, min(ids), max(ids))], FBETA, strict=False, degraded_ok=True)
                            assert len(ans) == 2
            for t, pid, _e in reg._pool.drain():
                must.discard((t, pid))
            reg.flush()
            observed = []
            for t in tenants:
                if t not in reg or not reg[t].ids():
                    continue
                ids = reg[t].ids()
                [ans] = reg.query_many([(t, min(ids), max(ids))], FBETA, strict=False, degraded_ok=True)
                if not getattr(ans, "degraded", False):
                    observed.append((t, list(ids), ans))
        for t, ids, ans in observed:
            assert_same_answer(_reference_answer(oracle, t, ids, min(ids), max(ids)), ans)
        for _ in range(2):
            t, pid, v = draw_item()
            try:
                reg.ingest_async(t, pid, v)
                must.add((t, pid))
            except IngestBackpressure:
                pass
        del reg  # crash: in-memory state gone, snapshot + log survive
        rec = TenantRegistry.recover(snap, wal_dir, salvage=True, num_buckets=FT, **CPU)
        for t, pid in sorted(must):
            assert t in rec and pid in rec[t].summaries, (t, pid)
        for t in rec.names():
            ids = rec[t].ids()
            assert {(t, pid) for pid in ids} <= set(oracle)
            if ids:
                [ans] = rec.query_many([(t, min(ids), max(ids))], FBETA, strict=False)
                assert_same_answer(_reference_answer(oracle, t, ids, min(ids), max(ids)), ans)
        rec.close()
    finally:
        faults.reset()
        shutil.rmtree(base, ignore_errors=True)
