"""The paper's end-to-end deployment: daily log summarization + on-demand
interval histograms — Summarizer/Merger (paper §5, Fig. 13) on PyTorch.

Port of ``examples/log_analytics.py``.  A month of synthetic web-server
latency logs is ingested day by day (the scheduled Summarizer job — here
through ``summarize_tiles``: the row-sort and merge kernels on the card).  Then on-demand Merger queries answer
the paper's motivating questions:

  * histogram of any time interval (last week / Christmas season),
  * 95th-percentile latency over any interval,
  * range-count queries with the ε_max guarantee,

all without re-touching raw data.  The Merger runs on the segment-tree
interval engine (core/interval_tree.py): each query merges only the
``≤ 2·log2 W`` pre-merged canonical node summaries instead of the whole
window, repeated dashboard windows are served from the LRU answer cache,
and a batch of concurrent users' queries goes through ``query_many`` as a
single merge launch.  Summaries AND tree nodes persist to disk (the HDFS
summary files) and the store answers from any subset if a day is lost.  The answers are
held to their guarantee on the data (the bucket count): each window's
true occupancy of its buckets within the store's ε plus the days' own
tile bounds.

Run: PYTHONPATH=src python -m repro_torch.examples.log_analytics [--smoke] [--device cpu]
(``--smoke`` shrinks every size for CI: same pipeline, tiny data;
``--device cpu`` runs the plain versions, the default is the card.)
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import HistogramStore, TenantRegistry, quantile, range_count
from repro_torch.kernels import bucket_sizes, summarize_tiles

# the last fsync's and each push's wall-clock ms, and what the async
# store had applied when the dashboard looked mid-ingest (a race)
CLOCK_FIELDS = (r"fsyncs, (\d+\.\d+) ms last", r"lag=(\d+\.\d+) ms", r"snapshot saw ([\d,]+) records")
MODEL_FIELDS = ()


def synth_day(rng, day: int, base: int = 65_536) -> np.ndarray:
    """Log-normal latency with a weekly cycle and holiday surge.

    Days have ragged lengths (real traffic is never tile-aligned) — the
    tile Summarizer masks the padded tail tile.
    """
    n = base + int(rng.integers(0, max(1, base // 16)))  # not tile-aligned
    scale = 1.0 + 0.25 * (day % 7 in (5, 6)) + 0.6 * (day >= 24)
    return (rng.lognormal(-1.8, 0.55, size=n) * scale).astype(np.float32)


def main(smoke: bool = False, device=None) -> None:
    rng = np.random.default_rng(0)
    T = 512 if smoke else 2048
    day_n = 8_192 if smoke else 65_536  # records per synthetic day
    svc_n, svc_step = (1_024, 16) if smoke else (8_192, 128)
    ret_n = 512 if smoke else 4_096
    store = HistogramStore(num_buckets=T, device=device)
    raw = {}

    print("== Summarizer (daily, offline — tile-sort kernels) ==")
    for day in range(31):
        v = synth_day(rng, day, day_n)
        raw[day] = v
        h = summarize_tiles(v, tile_len=4096, T_tile=512, T_out=T, device=device)
        store.ingest_summary(day, h)
    total = sum(len(v) for v in raw.values())
    print(f"ingested 31 ragged days ({total:,} records) "
          f"→ {31*(T*2+1)*4/1e6:.1f} MB of summaries (vs "
          f"{total*4/1e6:.0f} MB raw)")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "summaries.npz")
        store.save(path)
        store = HistogramStore.load(path, device=device)
        print(f"summaries persisted+reloaded ({os.path.getsize(path)/1e6:.1f} MB)")

    print("\n== Merger (on-demand interval queries, segment-tree engine) ==")
    for (lo, hi, label) in [(0, 30, "whole month"), (21, 27, "last week"),
                            (24, 30, "holiday season")]:
        nodes = len(store._tree.decompose(lo, hi))
        h, eps = store.query(lo, hi, beta=254)
        p95 = store.quantile_query(lo, hi, 0.95)
        truth = np.quantile(np.concatenate([raw[i] for i in range(lo, hi + 1)]), 0.95)
        n = store.total_n(range(lo, hi + 1))
        print(f"{label:16s} days {lo:2d}-{hi:2d}: p95={float(p95)*1e3:7.2f} ms "
              f"(true {truth*1e3:7.2f} ms)  ε_max={eps:.0f} "
              f"({eps/(n/254)*100:.1f}% of bucket; merged {nodes} of "
              f"{hi-lo+1} summaries)")
        # the guarantee on the data: the window's true occupancy (the
        # bucket count) within ε plus each day's tile bound (2n/T_tile + 2·tiles)
        vals = np.concatenate([raw[i] for i in range(lo, hi + 1)])
        true = bucket_sizes(vals, h.boundaries, device=device).cpu().numpy()
        day_eps = sum(2.0 * len(raw[i]) / 512 + 2.0 * -(-len(raw[i]) // 4096) for i in range(lo, hi + 1))
        assert true.sum() == n and np.abs(true - n / 254).max() <= eps + 2.0 * day_eps, (lo, hi)

    # range-count with guarantee: requests slower than 500 ms last week
    h, eps = store.query(21, 27, beta=254)
    cnt = float(range_count(h, np.float32(0.5), np.float32(1e9), device=device))
    true_cnt = sum(int((raw[i] >= 0.5).sum()) for i in range(21, 28))
    print(f"\nrequests ≥ 500 ms in days 21-27: ≈{cnt:,.0f} "
          f"(true {true_cnt:,}; bound ±{eps:.0f})")

    # a burst of concurrent dashboard users: one merge launch for the batch,
    # then the LRU serves the repeat windows without touching the device
    windows = [(0, 30), (21, 27), (24, 30), (7, 13), (14, 20)]
    store.query_many(windows, beta=254)
    for _ in range(3):  # the same dashboards refresh
        for (lo, hi) in windows:
            store.query(lo, hi, beta=254)
    stats = store.cache_stats()
    print(f"\nbatched {len(windows)} concurrent windows in one merge; "
          f"refresh traffic: {stats['hits']} cache hits / "
          f"{stats['misses']} misses")

    # fault tolerance: lose a day, answer degrades instead of failing
    del store.summaries[25]
    h, _ = store.query(21, 27, beta=64, strict=False)
    print(f"day 25 summary lost → query still answers over "
          f"{float(np.asarray(h.sizes).sum()):,.0f} records (6/7 days)")

    # next month arrives while the dashboards stay live: async ingest —
    # the Summarizer runs on a background thread (batched, shape-stable
    # dispatches), dashboards keep querying consistent snapshots, and
    # flush() is the explicit freshness barrier (no sleeps, no races)
    print("\n== async ingest (the next month, dashboards stay live) ==")
    live = HistogramStore(num_buckets=T, T_node="geometric",
                          async_ingest=True, device=device)
    for day in range(31):
        live.ingest(day, raw[day])  # enqueue: returns immediately
    snapshots = 0
    try:
        h, _ = live.query(0, 30, beta=254, strict=False)
        snapshots = int(float(np.asarray(h.sizes).sum()))
    except KeyError:
        pass  # nothing applied yet — also a consistent answer
    live.flush()
    h, eps = live.query(0, 30, beta=254)
    n = float(np.asarray(h.sizes).sum())
    print(f"mid-ingest snapshot saw {snapshots:,} records; after flush the "
          f"geometric-T_node store answers over {n:,.0f} "
          f"(ε_max {eps/(n/254)*100:.1f}% of bucket, depth-independent)")
    live.close()

    # production doesn't track one metric: every service's latency is its
    # own tenant of one registry — shared config, a single background
    # ingest pool, and a whole dashboard refresh (one window per service)
    # answered with ONE cross-tenant merge dispatch instead of N
    print("\n== multi-tenant serving (one registry, many services) ==")
    services = [f"svc-{s:02d}" for s in range(24)]
    reg = TenantRegistry(num_buckets=256, device=device)
    svc_days = {name: {} for name in services}
    for s, name in enumerate(services):
        for day in range(7):
            svc_days[name][day] = synth_day(rng, day, day_n)[: svc_n + svc_step * s]
            reg.ingest_async(name, day, svc_days[name][day])
    reg.flush()  # the explicit freshness barrier, as for a single store
    refresh = [(name, 0, 6) for name in services]
    reg.merge_dispatches = 0
    answers = reg.query_many(refresh, beta=64)
    p95s = [float(quantile(h, 0.95, device=device)) for h, _ in answers]
    print(f"{len(services)} services × 7 days ingested through the shared "
          f"pool; dashboard refresh of {len(refresh)} windows answered in "
          f"{reg.merge_dispatches} merge dispatch "
          f"(p95 spread {min(p95s)*1e3:.1f}-{max(p95s)*1e3:.1f} ms)")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "registry.npz")
        reg.save(path)  # every tenant in ONE atomic npz
        reloaded = TenantRegistry.load(path, device=device)
        h0, _ = reg.query(services[0], 0, 6, beta=64)
        h1, _ = reloaded.query(services[0], 0, 6, beta=64)
        same = bool(np.array_equal(np.asarray(h0.sizes), np.asarray(h1.sizes)))
        print(f"registry persisted+reloaded from one file "
              f"({os.path.getsize(path)/1e6:.1f} MB, answers identical: {same})")
    reg.close()

    # scale the registry up and the remaining per-tenant cost is storage:
    # every tree still owns its own little node arrays, so each dashboard
    # refresh re-packs its merge stack host-side, row by row.  A shared
    # NodeArena pools every service's nodes into one device-resident
    # (n_slots, T) pool — the refresh's whole merge stack is then
    # assembled with a single device gather (zero host row copies, the
    # counter proves it), the drained ingest batches pull up ALL touched
    # services with one merge dispatch per tree level, and save/load
    # writes the pool once per registry instead of per tenant
    print("\n== shared node-storage arena (one pool for every service) ==")
    arena_reg = TenantRegistry(num_buckets=256, shared_arena=True, device=device)
    for name in services:
        arena_reg.ingest_many(name, svc_days[name])
    arena_reg.merge_dispatches = 0
    arena_reg.reset_host_row_copies()
    answers2 = arena_reg.query_many(refresh, beta=64)
    same = all(
        np.array_equal(np.asarray(h0.sizes), np.asarray(h1.sizes))
        for (h0, _), (h1, _) in zip(answers, answers2)
    )
    print(f"{len(services)} services in ONE arena "
          f"({arena_reg.arena.allocated_floats():,} pooled floats, widths "
          f"{arena_reg.arena.widths()}); refresh answered in "
          f"{arena_reg.merge_dispatches} merge dispatch with "
          f"{arena_reg.host_row_copies} host row copies "
          f"(answers identical to per-tenant arrays: {same})")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "arena_registry.npz")
        arena_reg.save(path)  # node pools written once, compacted
        with np.load(path) as npz:  # context-managed: no leaked archive fd
            pool_keys = [k for k in npz.files if k.startswith("arena_")]
        print(f"persisted: one shared pool ({pool_keys}) instead of "
              f"{len(services)} per-tenant array dicts")
    arena_reg.close()

    # the stream never ends, but memory must: a sliding window makes the
    # paper's "for a given time interval" first-class — each day ingested
    # evicts the day that left the window (set_leaf's pull-up in reverse,
    # lazy subtree collapse behind it), answers over the retained window
    # stay bit-exact vs a flat rebuild of just those days, and the
    # watermark persists so a reloaded store resumes aging where it
    # stopped instead of resurrecting expired days
    print("\n== windowed retention (infinite stream, bounded memory) ==")
    from repro_torch.core import SlidingWindow, TTL

    win = HistogramStore(num_buckets=T, retention=SlidingWindow(7), device=device)
    for day in range(90):  # a quarter of traffic through a 7-day window
        win.ingest(day, synth_day(rng, day, day_n)[:ret_n])
    lo, hi = win.ids()[0], win.ids()[-1]
    h, eps = win.query(lo, hi, beta=64)
    print(f"90 days streamed, {len(win.ids())} retained "
          f"(days {lo}-{hi}), {win.node_floats():,} node floats steady "
          f"(unbounded would be ~{90 // 7}× that and growing); "
          f"p95 over the live window: "
          f"{float(quantile(h, 0.95, device=device))*1e3:.2f} ms")

    # tenant quotas: thousands of services share ONE memory envelope —
    # per-tenant TTL ages old days out, the registry budget evicts from
    # the largest-over-quota tenant first, so one noisy service cannot
    # squeeze out the rest
    budget = 24 * win.node_floats()  # room for ~24 window-sized tenants
    quota_reg = TenantRegistry(num_buckets=T, retention=TTL(max_age=6),
                               budget=budget, device=device)
    for s, name in enumerate(services):
        for day in range(10):  # 10 days in, TTL keeps the last 7
            quota_reg.ingest_async(name, day,
                                   synth_day(rng, day, day_n)[: ret_n // 2 + 8 * s])
    quota_reg.flush()  # retention + budget swept on the pool workers
    sizes = quota_reg.node_floats()
    days_kept = {len(quota_reg[name].ids()) for name in services}
    print(f"{len(services)} tenants under one {budget:,}-float budget: "
          f"total {sum(sizes.values()):,} floats "
          f"(fits: {sum(sizes.values()) <= budget}), per-tenant days kept "
          f"{sorted(days_kept)} (TTL window, newest never evicted)")
    quota_reg.close()

    # durability: everything above assumed the process lives until save().
    # In production the Summarizer node gets kill -9'd between an acked
    # ingest and the next snapshot — without a log those acked days are
    # silently gone.  wal_dir= gives the registry a segmented write-ahead
    # log: every ingest is appended + fsynced BEFORE the call returns
    # (concurrent submits share one group-commit fsync), recover() replays
    # the log suffix the snapshot doesn't cover (idempotent: pid dedup +
    # watermark reconciliation, torn trailing records dropped), and save()
    # truncates the covered segments.  See the "Write-ahead log" design
    # note in repro_torch/core/workers.py for the record format and invariants.
    print("\n== durable ingest (write-ahead log + crash recovery) ==")
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "registry.npz")
        wal = os.path.join(d, "wal")
        dur = TenantRegistry(num_buckets=256, wal_dir=wal, device=device)
        dur.ingest_many("frontend", {dy: svc_days["svc-00"][dy]
                                     for dy in range(4)})
        dur.save(snap)  # atomic snapshot; WAL truncated to the suffix
        for day in (4, 5):  # acked after the snapshot — only the WAL
            dur.ingest("frontend", day, svc_days["svc-00"][day])
        stats = dur.wal_stats()
        del dur  # kill -9: no close(), no save — in-memory state is gone

        crashed = TenantRegistry.recover(snap, wal, num_buckets=256, device=device)
        days = crashed["frontend"].ids()
        print(f"crash with {stats['appends']} acked ingests logged "
              f"({stats['fsyncs']} group-commit fsyncs, "
              f"{stats['last_fsync_seconds']*1e3:.2f} ms last): recovery "
              f"replayed {crashed.last_recovery['replayed']} of "
              f"{crashed.last_recovery['records_scanned']} logged records "
              f"→ days {days[0]}-{days[-1]} all present "
              f"(acked loss: {6 - len(days)})")
        crashed.close()

    # failures aren't an exception, they're the workload: the serving
    # plane is threaded with named failpoints (core/failpoints.py) so chaos
    # drills run in-process.  Arm a fault schedule and the plane degrades
    # instead of failing — stale answers are served flagged, with an
    # honestly widened ε; a per-tenant circuit breaker quarantines a
    # poisoned service (probing it back after cooldown) while the rest
    # keep serving; the integrity scrubber rebuilds bit-rotted summaries
    # from the WAL.  health() is the one pane of glass over all of it.
    print("\n== chaos drill (failpoints, degraded serving, self-healing) ==")
    import dataclasses

    from repro_torch.core import BreakerPolicy, TenantQuarantined, faults

    with tempfile.TemporaryDirectory() as d:
        chaos = TenantRegistry(
            num_buckets=256,
            wal_dir=os.path.join(d, "wal"),
            breaker=BreakerPolicy(threshold=2, cooldown=30.0),
            device=device,
        )
        week = {dy: svc_days["svc-00"][dy] for dy in range(6)}
        chaos.ingest_many("frontend", week)
        # degraded_ok opts this dashboard into stale-but-flagged serving:
        # fresh answers also record the membership snapshot that later
        # bounds how far a stale answer can have drifted
        [fresh] = chaos.query_many([("frontend", 0, 6)], 64,
                                   strict=False, degraded_ok=True)

        # the merge path goes down mid-refresh: the cached last-known-good
        # answer is served, flagged, its ε widened by the drift since
        chaos.ingest("frontend", 6, svc_days["svc-00"][6])
        with faults.inject("tenant.merge"):
            [ans] = chaos.query_many([("frontend", 0, 6)], 64,
                                     strict=False, degraded_ok=True)
        drift = len(svc_days["svc-00"][6])
        print(f"merge dispatch down → served last-known-good "
              f"(degraded={ans.degraded}, ε {fresh[1]:.0f} → {ans[1]:.0f}: "
              f"widened by the {drift:,} records of drift)")

        # a poisoned tenant trips its breaker and is quarantined at the
        # door; healthy tenants never notice
        with faults.inject("tenant.apply",
                           match=lambda ctx: ctx.get("tenant") == "mobile"):
            rejected = quarantined = 0
            for day in range(3):
                try:
                    chaos.ingest("mobile", day, week[day])
                except faults.FaultError:
                    rejected += 1
                except TenantQuarantined:
                    quarantined += 1
        chaos.ingest("frontend", 7, week[0])  # unaffected
        print(f"poisoned tenant: {rejected} failures tripped the breaker, "
              f"{quarantined} later ingest rejected at the door; "
              f"healthy tenants unaffected")

        # bit-rot on disk pages: the scrubber catches the bad checksum and
        # rebuilds the partition from its WAL records
        s = chaos["frontend"].summaries[3]
        bad = np.array(s.sizes)
        bad[0] += 1.0
        chaos["frontend"].summaries[3] = dataclasses.replace(s, sizes=bad)
        rep = chaos.scrub(repair=True)
        health = chaos.health()
        print(f"scrubber: {rep['checked']} summaries checked, corrupt "
              f"{rep['corrupt']} → repaired {rep['repaired']} by WAL "
              f"replay; health: status={health['status']}, "
              f"quarantined={health['quarantined']}, "
              f"degraded_served={health['degraded_served']}")
        chaos.close()

    # dashboards that poll re-ask unchanged questions forever.  A
    # standing subscription inverts it: register the window once, get an
    # Update pushed only when new data actually lands — subscribers
    # sharing a window share one evaluation, and everything stale on a
    # tick is answered with ONE cross-tenant merge dispatch
    # (serve/subscriptions.py)
    print("\n== standing dashboard (push subscriptions, no polling) ==")
    from repro_torch.serve.subscriptions import SubscriptionPlane

    dash = TenantRegistry(num_buckets=256, device=device)
    dash.ingest_many("frontend", {dy: svc_days["svc-00"][dy]
                                  for dy in range(6)})
    plane = SubscriptionPlane(dash)
    panels = {"month": (0, 30), "week": (0, 6), "today": (6, 6)}
    subs = {label: plane.subscribe("frontend", lo, hi, 64)
            for label, (lo, hi) in panels.items()}
    wall = plane.subscribe("frontend", 0, 6, 64)  # shares the week window
    plane.flush()  # initial answers pushed
    for sub in [*subs.values(), wall]:
        sub.drain()
    dash.ingest("frontend", 6, svc_days["svc-00"][6])  # day 6 arrives...
    plane.flush()  # ...and every panel's update is already in its queue
    for label, sub in subs.items():
        up = sub.drain()[-1]
        p95 = float(quantile(up.hist, 0.95, device=device))
        print(f"pushed {label:5s} (days {up.lo:2d}-{up.hi:2d}): "
              f"p95={p95*1e3:7.2f} ms  ε_max={up.eps:.0f}  "
              f"lag={up.lag_seconds*1e3:.1f} ms")
    stats = plane.stats()
    print(f"{stats['subscriptions']} standing panels, one ingest tick → "
          f"{stats['updates_delivered']} updates pushed, "
          f"{stats['windows_evaluated']} window evals "
          f"({stats['dedup_saved']} saved by sharing), "
          f"{stats['eval_batches']} merge dispatches total")
    plane.close()
    dash.close()
    print("\nlog_analytics OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI: same pipeline, minutes less data")
    ap.add_argument("--device", default=None, help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args()
    main(args.smoke, args.device)
