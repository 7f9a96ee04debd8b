"""The port's span and counter registry (``repro_torch.core.spans``), the
spans and counters the store's ingest path keeps with it, and the
benchmark's readers of them (``hbench/metrics/``)."""
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import HistogramStore, SlidingWindow, TenantRegistry, pad_pow2, spans

CPU = {"device": "cpu"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in spans.snapshot().items()}


class FakeClock:
    """``perf_counter_ns`` that advances ``step`` ns a read."""

    def __init__(self, step=10):
        self.now, self.step = 0, step

    def perf_counter_ns(self):
        self.now += self.step
        return self.now


def test_snapshot_holds_every_declared_name():
    snap = spans.snapshot()
    want = {f"span_{p}.{n}" for n in spans.SPANS for p in ("calls", "ns", "self_ns")} | set(spans.COUNTERS)
    assert set(snap) == want and all(isinstance(v, int) for v in snap.values())
    assert not any(n.startswith("hbench.") for n in spans.SPANS)  # the harness's own spans tag device work


@pytest.mark.parametrize("call", [lambda: spans.span("store.nope"), lambda: spans.count("nope", 1)])
def test_an_undeclared_name_raises(call):
    with pytest.raises(KeyError):
        call()


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    monkeypatch.setattr(spans, "time", FakeClock(10))
    s0 = spans.snapshot()
    with spans.span("store.ingest"):  # reads 10 at entry
        with spans.span("store.pad"):  # 20 .. 30
            pass
        with spans.span("store.stack"):  # 40 .. 70
            with spans.span("store.h2d"):  # 50 .. 60
                pass
    # store.ingest exits at 80
    d = delta(s0)
    assert d["span_ns.store.ingest"] == 70 and d["span_self_ns.store.ingest"] == 70 - 10 - 30
    assert d["span_ns.store.stack"] == 30 and d["span_self_ns.store.stack"] == 20
    assert d["span_ns.store.pad"] == d["span_self_ns.store.pad"] == 10
    assert d["span_ns.store.h2d"] == d["span_self_ns.store.h2d"] == 10
    assert all(d[f"span_calls.{n}"] == 1 for n in ("store.ingest", "store.pad", "store.stack", "store.h2d"))


def test_a_span_that_raises_is_counted_and_leaves_the_stack_clean():
    s0 = spans.snapshot()
    with pytest.raises(ValueError):
        with spans.span("store.ingest"):
            with spans.span("store.validate"):
                raise ValueError("bad partition")
    with spans.span("store.retention"):
        pass
    d = delta(s0)
    assert d["span_calls.store.ingest"] == d["span_calls.store.validate"] == d["span_calls.store.retention"] == 1
    assert d["span_self_ns.store.retention"] == d["span_ns.store.retention"]  # no stale parent took it as a child


def test_two_threads_spans_do_not_mix():
    """Thread B's child span opens while thread A's span is the newest
    open one in the process: it must count against B's parent only."""
    a_open, b_done, a_done = threading.Event(), threading.Event(), threading.Event()
    errors = []

    def thread_a():
        try:
            with spans.span("store.ingest"):
                a_open.set()
                assert b_done.wait(30)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
        finally:
            a_done.set()

    def thread_b():
        try:
            with spans.span("store.tree_update"):
                assert a_open.wait(30)
                with spans.span("store.retention"):
                    torch.ones(64).sum()
        except BaseException as e:
            errors.append(e)
        finally:
            b_done.set()

    s0 = spans.snapshot()
    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and a_done.is_set() and not errors, errors
    d = delta(s0)
    assert d["span_self_ns.store.ingest"] == d["span_ns.store.ingest"]  # B's child is not A's
    assert d["span_self_ns.store.tree_update"] == d["span_ns.store.tree_update"] - d["span_ns.store.retention"]


def test_no_record_function_while_no_profiler_runs(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    store = HistogramStore(num_buckets=8, **CPU)
    store.ingest(0, np.arange(100, dtype=np.float32))
    store.query_many([(0, 0)], 4)
    assert entered == []


def test_under_the_profiler_a_span_is_an_annotation_nested_in_its_parent(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    store = HistogramStore(num_buckets=8, **CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        store.ingest(0, np.arange(1000, dtype=np.float32))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_name = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    outer, inner = by_name["store.ingest"], by_name["store.pad"]
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


PARTS_F32 = {0: np.linspace(0, 1, 1000, dtype=np.float32)}


@pytest.mark.parametrize(
    "parts,padded,copied,uploaded",
    [
        # 24 sentinels, written on the device; no host array is made, and
        # the 1000 real values are uploaded
        (PARTS_F32, 24, 0, 1000 * 4),
        # float64 is narrowed first: the one host copy, 1000 × 4 B
        ({0: np.linspace(0, 1, 1000)}, 24, 1000 * 4, 1000 * 4),
        # a power of two is not padded
        ({0: np.linspace(0, 1, 1024, dtype=np.float32)}, 0, 0, 1024 * 4),
        # three rows to four: the duplicated row, copied on the device, is
        # all padding
        ({p: np.linspace(p, 1, 1000, dtype=np.float32) for p in range(3)}, 3 * 24 + 1024, 0, 3 * 1000 * 4),
    ],
    ids=["float32", "float64", "pow2", "three_rows"],
)
def test_ingest_counts_its_padding_and_host_copies(parts, padded, copied, uploaded):
    store = HistogramStore(num_buckets=8, **CPU)
    s0 = spans.snapshot()
    if len(parts) == 1:
        ((pid, values),) = parts.items()
        store.ingest(pid, values)
    else:
        store.ingest_many(parts)
    d = delta(s0)
    assert d["ingest.padded_values"] == padded
    assert d["ingest.host_copy_bytes"] == copied
    assert d["ingest.upload_bytes"] == uploaded


def test_one_ingest_and_one_query_many_hit_every_span(tmp_path):
    store = HistogramStore(num_buckets=8, retention=SlidingWindow(4), wal_dir=str(tmp_path / "wal"), **CPU)
    s0 = spans.snapshot()
    store.ingest(0, np.linspace(0, 1, 1000, dtype=np.float32))
    store.query_many([(0, 0)], 4)  # the Merger keeps no spans: it adds nothing here
    d = delta(s0)
    assert {n for n in spans.SPANS if n.startswith("store.") and d[f"span_calls.{n}"] < 1} == set()
    assert d["span_self_ns.store.ingest"] <= d["span_ns.store.ingest"]
    store.close()


def test_one_ingest_into_a_31_leaf_tree_pulls_up_at_most_once_a_level():
    store = HistogramStore(num_buckets=8, **CPU)
    store.ingest_many({p: np.linspace(p, p + 1, 64, dtype=np.float32) for p in range(30)})
    s0 = spans.snapshot()
    store.ingest(30, np.linspace(30, 31, 64, dtype=np.float32))
    d = delta(s0)
    assert store._tree.num_leaves() == 31 and store._tree.levels == 5
    assert 1 <= d["pullup.dispatches"] <= store._tree.levels
    assert d["pullup.pair_merges"] >= d["pullup.dispatches"]


def test_the_ingest_pool_counts_its_queue_wait():
    store = HistogramStore(num_buckets=8, async_ingest=True, **CPU)
    assert store._pool.stats()["queue_wait_ms_mean"] == 0.0  # no item taken yet
    s0 = spans.snapshot()
    for p in range(3):
        store.ingest(p, np.linspace(p, p + 1, 64, dtype=np.float32))
    store.flush()
    d = delta(s0)
    pool = store._pool
    assert pool.items == 3 and pool.queue_wait_ns > 0  # counted before flush() returns
    assert pool.stats()["queue_wait_ms_mean"] == pytest.approx(pool.queue_wait_ns / 3 * 1e-6)
    assert d["span_calls.store.ingest"] >= 1  # the worker's batches
    store.close()


def test_health_reports_the_pools_queue_wait():
    reg = TenantRegistry(8, device="cpu")
    reg.ingest_async("a", 0, np.linspace(0, 1, 64, dtype=np.float32))
    reg.flush()
    assert reg.health()["pool"]["queue_wait_ms_mean"] > 0
    reg.close()


@pytest.mark.parametrize("values", [np.linspace(0, 1, 1000, dtype=np.float32), np.arange(1000, dtype=np.int32),
                                    np.arange(5, dtype=np.float32)])
def test_pad_pow2_counts_the_arrays_it_makes(values, monkeypatch):
    """The counts are what pad_pow2 allocated: its fill and its padded copy."""
    made = []
    full, concatenate = np.full, np.concatenate
    monkeypatch.setattr(np, "full", lambda *a, **k: made.append(full(*a, **k)) or made[-1])
    monkeypatch.setattr(np, "concatenate", lambda *a, **k: made.append(concatenate(*a, **k)) or made[-1])
    s0 = spans.snapshot()
    padded, n = pad_pow2(values)
    d = delta(s0)
    monkeypatch.undo()
    assert n == values.size and padded is made[-1]
    assert d["ingest.padded_values"] == made[0].size == padded.size - n
    assert d["ingest.host_copy_bytes"] == sum(a.nbytes for a in made)


def test_pad_pow2_counts_nothing_where_it_makes_nothing():
    values = np.linspace(0, 1, 1024, dtype=np.float32)
    s0 = spans.snapshot()
    padded, n = pad_pow2(values)
    d = delta(s0)
    assert np.shares_memory(padded, values) and n == 1024
    assert d["ingest.padded_values"] == d["ingest.host_copy_bytes"] == 0


def _reader(name):
    path = os.path.join(ROOT, "hbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# one paper day: 161,290,322 values padded to 2^28, the host copies of
# padding on the host, the real values uploaded (one day of the two through
# a pinned staging ring), and 1.0 s of padding and
# stacking; 20 ms of tree upkeep over two partitions
DAY, PAD = 161_290_322, 2**28 - 161_290_322
COUNTERS = {
    "values": 2 * DAY, "partitions": 2, "ingest.padded_values": 2 * PAD,
    "ingest.host_copy_bytes": 2 * (4 * PAD + 2 * 4 * 2**28), "ingest.upload_bytes": 2 * 4 * DAY,
    "ingest.pinned_bytes": 4 * DAY,
    "span_ns.store.pad": 1_200_000_000, "span_ns.store.stack": 800_000_000,
    "span_ns.store.tree_update": 8_000_000, "span_ns.store.retention": 12_000_000,
}


@pytest.mark.parametrize(
    "name,want",
    [
        ("host_prep_ms_per_gvalue.ingest", 2000.0 / (2 * DAY * 1e-9)),
        ("host_copy_bytes_per_value.ingest", (4 * PAD + 2 * 4 * 2**28) / DAY),
        ("pad_share.ingest", 100.0 * PAD / 2**28),
        ("tree_ms_per_partition.ingest", 10.0),
        ("upload_bytes_per_value.ingest", 4.0),
        ("pinned_share.ingest", 50.0),
    ],
)
def test_a_reader_of_the_programs_spans_and_counters(name, want):
    read = _reader(name)
    run = {"config": {"num_buckets": 8}, "traffic": {"beta": 4}, "trace": None, "counters": dict(COUNTERS)}
    assert read(run) == pytest.approx(want, rel=1e-12)
    # the parent commit's program keeps none of these keys; an empty window ingests nothing
    empty = {"tile_sort": 0, "merge_cut": 0, "cache_hits": 0, "cache_misses": 0, "partitions": 0, "values": 0,
             "requests": 0}
    assert read({**run, "counters": empty}) is None
    assert read({**run, "counters": {**COUNTERS, "values": 0, "partitions": 0}}) is None
