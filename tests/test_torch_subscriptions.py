"""Port parity: ``repro_torch.serve.subscriptions`` against ``repro``'s.

Mirrors every case of ``tests/test_subscriptions.py``.  Each case is one
scenario run twice, on the same seeded NumPy inputs: once through the
reference package and once through the port (``device="cpu"``: the
kernels' plain versions).  The reference test's assertions hold for both
runs, and every update a scenario reads is then held bit-equal between
the two packages: boundaries and sizes (bits and dtype), ε, the store
version it was evaluated at and the degraded flag.

Sequencing is entirely event-driven (``plane.flush()`` barriers) — no
sleeps anywhere.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R
import repro.serve as RS
import repro_torch.core as C
import repro_torch.serve as CS

if os.environ.get("REPRO_LOCK_WITNESS") == "1":
    # tests/conftest.py arms only the reference's witness
    from repro_torch.analysis import witness as _witness

    _witness.arm()

T = 8
BETA = 16
N_VALUES = 32

REF = SimpleNamespace(
    name="ref", core=R, serve=RS, kw={}, hub=R.TelemetryHub
)
PORT = SimpleNamespace(
    name="port", core=C, serve=CS, kw={"device": "cpu"}, hub=C.TelemetryHub
)


@pytest.fixture(autouse=True)
def _disarm():
    R.faults.reset()
    C.faults.reset()
    yield
    R.faults.reset()
    C.faults.reset()


def _mk(pkg, **kw):
    reg = pkg.core.TenantRegistry(num_buckets=T, **pkg.kw, **kw)
    return reg, pkg.serve.SubscriptionPlane(reg)


def _cold_pull(reg, key):
    """Fresh-from-the-tree answer for one subscription key — the caches
    are cleared first, so a pushed answer cannot match by aliasing."""
    name, lo, hi, beta = key
    reg[name]._tree._cache.clear()
    [ans] = reg.query_many([(name, lo, hi)], beta, strict=False)
    return ans


def _assert_update_matches_pull(reg, update):
    hist, eps = _cold_pull(
        reg, (update.tenant, update.lo, update.hi, update.beta)
    )
    assert (update.hist is None) == (hist is None)
    if hist is not None:
        assert np.array_equal(
            np.asarray(update.hist.boundaries), np.asarray(hist.boundaries)
        )
        assert np.array_equal(
            np.asarray(update.hist.sizes), np.asarray(hist.sizes)
        )
    assert update.eps == eps


def _facts(update):
    """What must agree between the packages for one pushed update."""
    if update is None:
        return None
    hist = None
    if update.hist is not None:
        b = np.asarray(update.hist.boundaries)
        s = np.asarray(update.hist.sizes)
        hist = (b.dtype.str, b.tobytes(), s.dtype.str, s.tobytes())
    return (
        update.tenant, update.lo, update.hi, update.beta, hist,
        float(update.eps), update.version, bool(update.degraded),
    )


def _same_pushes(scenario, *args):
    """Run ``scenario`` on both packages; their updates agree bit for bit."""
    ref, port = scenario(REF, *args), scenario(PORT, *args)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert _facts(r) == _facts(p)
    return port


def _push_matches_pull(pkg, shared_arena):
    rng = np.random.default_rng(7 + shared_arena)
    reg, plane = _mk(pkg, shared_arena=shared_arena, budget=6000)
    tenants = ["t0", "t1", "t2"]
    live = []
    last_up = {}
    next_pid = {t: 0 for t in tenants}
    try:
        for step in range(40):
            op = rng.integers(0, 10)
            t = tenants[int(rng.integers(0, 3))]
            if op < 5:  # ingest (ticks the plane, may evict under budget)
                next_pid[t] += int(rng.integers(1, 3))
                reg.ingest(t, next_pid[t], rng.normal(size=N_VALUES))
            elif op < 7:  # subscribe a random window
                lo = int(rng.integers(0, max(1, next_pid[t])))
                hi = lo + int(rng.integers(0, 8))
                live.append(plane.subscribe(t, lo, hi, BETA))
            elif op < 8 and live:  # unsubscribe
                sub = live.pop(int(rng.integers(0, len(live))))
                plane.unsubscribe(sub)
                last_up.pop(id(sub), None)
            elif op < 9:  # explicit eviction sweep
                reg.enforce_budget()
            else:  # barrier + spot-check everything delivered so far
                plane.flush()
                for sub in live:
                    ups = sub.drain()
                    if ups:
                        last_up[id(sub)] = ups[-1]
        plane.flush()  # final barrier: every sub now has a current answer
        out = []
        for sub in live:
            ups = sub.drain()
            if ups:
                last_up[id(sub)] = ups[-1]
            up = last_up.get(id(sub))
            assert up is not None, f"no update ever pushed for {sub.key}"
            assert not up.degraded  # no faults armed here
            assert up.version == reg[sub.key[0]].version
            _assert_update_matches_pull(reg, up)
            out.append(up)
        stats = plane.stats()
        assert stats["updates_delivered"] > 0
        assert stats["dropped"] == 0  # coalesce default drops nothing
        return out
    finally:
        plane.close()
        reg.close()


@pytest.mark.parametrize("shared_arena", [False, True])
def test_push_matches_pull_bit_identical(shared_arena):
    """Random interleavings of ingest / budget-eviction / subscribe /
    unsubscribe: after every flush barrier, each live subscriber's latest
    pushed answer bit-matches a cold pull at the same store version — and
    the port's pushes bit-match the reference's."""
    assert _same_pushes(_push_matches_pull, shared_arena)


def _dedup(pkg):
    reg, plane = _mk(pkg)
    try:
        rng = np.random.default_rng(0)
        store = reg.tenant("m")  # store-level: no plane ticks while priming
        store.ingest(0, rng.normal(size=N_VALUES))
        store.ingest(1, rng.normal(size=N_VALUES))
        subs = [plane.subscribe("m", w, w, BETA) for w in (0, 1)
                for _ in range(5)]
        d0 = reg.merge_dispatches
        plane.flush()
        assert reg.merge_dispatches - d0 == 1
        st = plane.stats()
        assert st["windows_evaluated"] == 2
        assert st["eval_batches"] == 1
        assert st["updates_delivered"] == 10
        assert st["dedup_saved"] == 8
        out = []
        for sub in subs:
            [up] = sub.drain()
            _assert_update_matches_pull(reg, up)
            out.append(up)
        return out
    finally:
        plane.close()
        reg.close()


def test_dedup_shared_windows_one_eval():
    """10 subscribers over 2 distinct windows: one tick costs exactly 2
    window evaluations, 1 merge dispatch, 10 deliveries, 8 saved."""
    assert len(_same_pushes(_dedup)) == 10


def _cross_tenant(pkg):
    reg, plane = _mk(pkg, shared_arena=True)
    try:
        rng = np.random.default_rng(1)
        names = [f"t{i}" for i in range(6)]
        subs = [plane.subscribe(n, 0, 4, BETA) for n in names]
        for n in names:  # store-level ingest: versions move, no ticks
            for pid in range(3):
                reg.tenant(n).ingest(pid, rng.normal(size=N_VALUES))
        out = []
        for tick in range(3):
            d0 = reg.merge_dispatches
            b0 = plane.stats()["eval_batches"]
            for n in names:
                reg.tenant(n).ingest(3 + tick, rng.normal(size=N_VALUES))
            plane.mark_stale(names)  # ONE tick covering all six tenants
            plane.flush()
            assert reg.merge_dispatches - d0 == 1
            assert plane.stats()["eval_batches"] - b0 == 1
        for sub in subs:
            ups = sub.drain()
            assert ups  # every tick pushed (cap 8 > 3 ticks: none lost)
            _assert_update_matches_pull(reg, ups[-1])
            out.append(ups[-1])
        return out
    finally:
        plane.close()
        reg.close()


def test_one_dispatch_per_tick_cross_tenant():
    """Stale windows across MANY tenants still pack into a single
    cross-tenant ``query_many`` merge dispatch per tick."""
    assert len(_same_pushes(_cross_tenant)) == 6


def _coalesce(pkg):
    reg, plane = _mk(pkg)
    try:
        rng = np.random.default_rng(2)
        sub = plane.subscribe("m", 0, 8, BETA, queue_cap=1)
        for pid in range(3):
            reg.ingest("m", pid, rng.normal(size=N_VALUES))
            plane.flush()
        st = sub.stats()
        assert st["delivered"] == 3
        assert st["coalesced"] == 2  # two older updates displaced
        assert st["pending"] == 1
        [up] = sub.drain()
        assert up.version == reg["m"].version  # the survivor is newest
        _assert_update_matches_pull(reg, up)
        return [up]
    finally:
        plane.close()
        reg.close()


def test_coalesce_policy_keeps_newest():
    _same_pushes(_coalesce)


def _drop(pkg):
    reg, plane = _mk(pkg)
    try:
        rng = np.random.default_rng(3)
        sub = plane.subscribe("m", 0, 8, BETA, policy="drop", queue_cap=1)
        versions = []
        for pid in range(3):
            reg.ingest("m", pid, rng.normal(size=N_VALUES))
            plane.flush()
            versions.append(reg["m"].version)
        st = sub.stats()
        assert st["delivered"] == 1  # only the first made it in
        assert st["dropped"] == 2  # the two newer ones were the casualties
        [up] = sub.drain()
        assert up.version == versions[0]  # oldest kept — drop ≠ coalesce
        return [up]
    finally:
        plane.close()
        reg.close()


def test_drop_policy_discards_newest_and_counts():
    _same_pushes(_drop)


def _block(pkg):
    reg, plane = _mk(pkg)
    try:
        rng = np.random.default_rng(4)
        sub = plane.subscribe("m", 0, 8, BETA, policy="block", queue_cap=1)
        reg.ingest("m", 0, rng.normal(size=N_VALUES))
        plane.flush()
        v0 = reg["m"].version
        reg.ingest("m", 1, rng.normal(size=N_VALUES))  # worker now blocks
        first = sub.get(timeout=10.0)  # frees the slot, unblocks delivery
        assert first is not None and first.version == v0
        plane.flush()  # completes only because the consumer drained
        second = sub.get(timeout=10.0)
        assert second is not None
        assert second.version == reg["m"].version
        st = sub.stats()
        assert st["coalesced"] == 0 and st["dropped"] == 0  # nothing lost
        _assert_update_matches_pull(reg, second)
        return [first, second]
    finally:
        plane.close()
        reg.close()


def test_block_policy_backpressures_until_consumer_drains():
    """cap=1 block subscriber: the second update waits for the consumer;
    ``get()`` frees the slot and the flush barrier then completes."""
    _same_pushes(_block)


def _invalid(pkg):
    reg, plane = _mk(pkg)
    try:
        with pytest.raises(ValueError):
            plane.subscribe("m", 0, 1, BETA, policy="mystery")
        with pytest.raises(ValueError):
            plane.subscribe("m", 0, 1, BETA, queue_cap=0)
        assert len(plane) == 0
        return []
    finally:
        plane.close()
        reg.close()


def test_invalid_policy_and_cap_rejected():
    _same_pushes(_invalid)
    assert CS.POLICIES == RS.subscriptions.POLICIES


def _quarantine(pkg):
    policy = pkg.core.BreakerPolicy(threshold=1, cooldown=0.0, probes=1)
    reg, plane = _mk(pkg, breaker=policy)
    faults = pkg.core.faults
    try:
        rng = np.random.default_rng(5)
        sub = plane.subscribe("m", 0, 8, BETA)
        reg.ingest("m", 0, rng.normal(size=N_VALUES))
        plane.flush()
        [fresh0] = sub.drain()
        assert not fresh0.degraded
        with faults.inject("tenant.apply"):
            with pytest.raises(faults.FaultError):
                reg.ingest("m", 1, rng.normal(size=N_VALUES))
        assert reg._breakers["m"].state == "open"
        reg.tenant("m").ingest(2, rng.normal(size=N_VALUES))
        plane.mark_stale(["m"])
        plane.flush()
        # a degraded window is re-pushed on EVERY pass until it heals
        # (tick and flush may coalesce into one pass or run as two)
        degs = sub.drain()
        assert degs and all(u.degraded for u in degs)
        deg = degs[-1]
        assert deg.eps >= fresh0.eps  # honestly widened
        assert plane.stats()["degraded_pushed"] == len(degs)
        reg.ingest("m", 3, rng.normal(size=N_VALUES))
        plane.flush()
        ups = sub.drain()
        assert ups and not ups[-1].degraded
        assert ups[-1].version == reg["m"].version
        _assert_update_matches_pull(reg, ups[-1])
        return [fresh0, deg, ups[-1]]
    finally:
        plane.close()
        reg.close()


def test_quarantined_tenant_pushes_degraded_then_heals():
    """Breaker-open tenant: subscribers get the last-known-good answer
    flagged degraded (never advancing their version); breaker closed →
    the next tick re-pushes fresh, bit-matching the pull path."""
    _same_pushes(_quarantine)


def _close_and_health(pkg):
    reg, plane = _mk(pkg)
    rng = np.random.default_rng(6)
    sub = plane.subscribe("m", 0, 4, BETA)
    reg.ingest("m", 0, rng.normal(size=N_VALUES))
    plane.flush()
    health = reg.health()
    assert health["subscriptions"]["subscriptions"] == 1
    assert health["subscriptions"]["updates_delivered"] == 1
    assert health["subscriptions"]["last_lag_seconds"] >= 0.0
    reg.close()  # closes attached planes
    assert sub.closed
    up = sub.get(timeout=0.0)
    assert up is not None  # pending update still readable
    with pytest.raises(RuntimeError):
        plane.subscribe("m", 0, 1, BETA)
    return [up]


def test_registry_close_closes_planes_and_health_surfaces_stats():
    _same_pushes(_close_and_health)


def _unsubscribe(pkg):
    reg, plane = _mk(pkg)
    try:
        rng = np.random.default_rng(8)
        keep = plane.subscribe("m", 0, 8, BETA)
        gone = plane.subscribe("m", 0, 8, BETA)
        reg.ingest("m", 0, rng.normal(size=N_VALUES))
        plane.flush()
        assert len(gone.drain()) == 1
        plane.unsubscribe(gone)
        assert len(plane) == 1
        reg.ingest("m", 1, rng.normal(size=N_VALUES))
        plane.flush()
        assert gone.pending() == 0  # closed endpoints receive nothing
        kept = keep.drain()
        assert len(kept) == 2
        plane.unsubscribe(keep)
        # last subscriber gone: tenant refs and the eval cache both prune
        plane.flush()
        assert plane.stats()["tenants"] == 0
        assert not plane._seen
        return kept
    finally:
        plane.close()
        reg.close()


def test_unsubscribe_stops_deliveries_and_prunes_state():
    _same_pushes(_unsubscribe)


def _service(pkg, root):
    svc = pkg.serve.HistogramService(
        os.path.join(root, pkg.name), num_buckets=T, **pkg.kw
    )
    try:
        rng = np.random.default_rng(9)
        sub = svc.subscribe("latency_ms", 0, 4, BETA)
        svc.record("latency_ms", 0, rng.normal(size=N_VALUES))
        svc.subscriptions.flush()
        [up] = sub.drain()
        assert up.tenant == "latency_ms" and not up.degraded
        _assert_update_matches_pull(svc.registry, up)
        assert svc.health()["subscriptions"]["subscriptions"] == 1
        svc.unsubscribe(sub)
        assert sub.closed
        return [up]
    finally:
        svc.close()


def test_service_surface(tmp_path):
    """HistogramService exposes subscribe/unsubscribe; updates ride the
    durable record() path and health() carries the plane stats."""
    _same_pushes(_service, str(tmp_path))


def _hub(pkg):
    hub = pkg.hub(T=T, **pkg.kw)
    try:
        rng = np.random.default_rng(10)
        s1 = hub.subscribe("grad_norm", 0, 4, BETA)
        s2 = hub.subscribe("step_ms", 0, 4, BETA)
        assert s1.plane is s2.plane
        hub.record("grad_norm", 0, rng.normal(size=N_VALUES))
        s1.plane.flush()
        [up] = s1.drain()
        assert up.tenant == "grad_norm"
        hub.unsubscribe(s1)
        assert s1.closed and not s2.closed
        return [up]
    finally:
        hub.close()


def test_hub_surface():
    """TelemetryHub.subscribe reuses one plane across calls."""
    _same_pushes(_hub)


def test_hub_subscribe_builds_the_ports_plane():
    """The hub's lazily built plane is the port's, on the hub's registry,
    and registered as its one stale listener."""
    hub = C.TelemetryHub(T=T, device="cpu")
    try:
        sub = hub.subscribe("m", 0, 1, BETA)
        assert type(sub.plane) is CS.SubscriptionPlane
        assert hub.registry._stale_listeners == [sub.plane]
        assert str(hub.registry.device) == "cpu"
    finally:
        hub.close()
