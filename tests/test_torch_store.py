"""Port parity: ``repro_torch``'s ``HistogramStore`` against ``repro``'s.

A small store built by both packages from the same seeded NumPy
partitions (ragged, some shorter than ``T``) must hold bit-identical
summaries and give bit-identical ``query``/``query_many`` answers and ε,
under both engines and both ``T_node`` modes.  Also: retention, async
ingest, npz and WAL state crossing between the packages in both
directions, ``convert.store_from_reference``, and the int64-sentinel
fault of the reference store that the port does not copy.  The port runs
on the CPU here (``device="cpu"``: the kernels' plain versions).
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch import convert
from repro_torch.core import HistogramStore, SlidingWindow, build_exact, spans
from repro_torch.core.histogram import build_exact_padded_batched, next_pow2, pad_pow2

if os.environ.get("REPRO_LOCK_WITNESS") == "1":
    # tests/conftest.py arms only the reference's witness
    from repro_torch.analysis import witness as _witness

    _witness.arm()

T = 16
BETA = 5


def partitions(seed: int, count: int = 11) -> dict[int, np.ndarray]:
    rng = np.random.default_rng(seed)
    lens = [3, 16, 40, 100, 7, 64, 200, 1, 33, 129, 16, 90, 15]
    return {
        p: (rng.gumbel(size=lens[p % len(lens)]) * 10).astype(np.float32)
        for p in range(count)
    }


def windows(count: int) -> list[tuple[int, int]]:
    return [(lo, hi) for lo in range(count) for hi in range(lo, count)]


def assert_same_answer(ra, pa):
    (hr, er), (hp, ep) = ra, pa
    br, bp = np.asarray(hr.boundaries), np.asarray(hp.boundaries)
    sr, sp = np.asarray(hr.sizes), np.asarray(hp.sizes)
    assert br.dtype == bp.dtype and sr.dtype == sp.dtype
    assert np.array_equal(br, bp) and np.array_equal(sr, sp)
    assert er == ep


def assert_same_summaries(rs, ps):
    assert sorted(rs.summaries) == sorted(ps.summaries)
    for pid, a in rs.summaries.items():
        b = ps.summaries[pid]
        assert a.n == b.n and a.crc == b.crc, pid
        assert a.boundaries.dtype == b.boundaries.dtype, pid
        assert np.array_equal(a.boundaries, b.boundaries), pid
        assert np.array_equal(a.sizes, b.sizes), pid


def assert_same_store(rs, ps, count: int, beta: int = BETA):
    assert_same_summaries(rs, ps)
    wins = windows(count)
    for lo, hi in wins[:: max(1, len(wins) // 12)]:
        assert_same_answer(rs.query(lo, hi, beta), ps.query(lo, hi, beta))
    for ra, pa in zip(rs.query_many(wins, beta), ps.query_many(wins, beta)):
        assert_same_answer(ra, pa)


@pytest.mark.parametrize("engine", ["tree", "flat"])
@pytest.mark.parametrize("T_node", [None, "geometric"])
def test_ingest_many_and_queries_bit_identical(engine, T_node):
    parts = partitions(1)
    rs = R.HistogramStore(num_buckets=T, engine=engine, T_node=T_node)
    ps = HistogramStore(num_buckets=T, engine=engine, T_node=T_node, device="cpu")
    rs.ingest_many(parts)
    ps.ingest_many(parts)
    assert_same_store(rs, ps, len(parts))
    assert rs.summarize_shapes == ps.summarize_shapes
    assert rs._tree.merge_shapes == ps._tree.merge_shapes
    q = np.array([0.1, 0.5, 0.95])
    np.testing.assert_allclose(rs.quantile_query(0, 10, q), ps.quantile_query(0, 10, q), rtol=1e-6)


def test_integer_and_float64_partitions_and_uniform_T_node():
    rng = np.random.default_rng(2)
    parts = {
        0: rng.integers(-50, 50, size=70).astype(np.int32),
        1: rng.normal(size=90),  # float64: summarized in float32 by both
        2: rng.integers(-50, 50, size=5).astype(np.int32),
        3: rng.normal(size=33).astype(np.float32),
    }
    rs = R.HistogramStore(num_buckets=T, T_node=8)
    ps = HistogramStore(num_buckets=T, T_node=8, device="cpu")
    for pid, v in parts.items():  # one at a time: the incremental pull-up
        rs.ingest(pid, v)
        ps.ingest(pid, v)
    assert ps.summaries[0].boundaries.dtype == np.int32
    assert ps.summaries[1].boundaries.dtype == np.float32
    assert_same_store(rs, ps, len(parts), beta=3)
    # one batch: partitions of one padded length but different dtypes
    # share one summarizer stack, which promotes (and is narrowed) as one
    mixed = {
        0: rng.integers(-50, 50, size=70).astype(np.int32),
        1: rng.normal(size=90),
        2: rng.integers(-50, 50, size=100),  # int64, padded beside floats
        3: rng.normal(size=120).astype(np.float16),
        4: rng.integers(-5, 5, size=80).astype(np.int16),
    }
    rs, ps = R.HistogramStore(num_buckets=T), HistogramStore(num_buckets=T, device="cpu")
    rs.ingest_many(mixed)
    ps.ingest_many(mixed)
    assert ps.summaries[2].boundaries.dtype == np.float32
    assert_same_store(rs, ps, len(mixed), beta=3)
    solo = {0: mixed[3], 1: mixed[4]}  # a group of its own keeps its dtype
    rs, ps = R.HistogramStore(num_buckets=T), HistogramStore(num_buckets=T, device="cpu")
    rs.ingest_many({0: mixed[3]})
    ps.ingest_many({0: mixed[3]})
    rs.ingest_many({1: mixed[4]})
    ps.ingest_many({1: mixed[4]})
    assert ps.summaries[0].boundaries.dtype == np.float16
    assert ps.summaries[1].boundaries.dtype == np.int16
    assert_same_store(rs, ps, len(solo), beta=3)


def test_sliding_window_eviction_matches():
    parts = partitions(3, count=13)
    rs = R.HistogramStore(num_buckets=T, retention=R.SlidingWindow(5))
    ps = HistogramStore(num_buckets=T, retention=SlidingWindow(5), device="cpu")
    for lo in range(0, 13, 4):
        batch = {p: parts[p] for p in range(lo, min(lo + 4, 13))}
        rs.ingest_many(batch)
        ps.ingest_many(batch)
        assert rs.ids() == ps.ids() and rs.watermark == ps.watermark
    assert ps.ids() == [8, 9, 10, 11, 12]
    assert_same_summaries(rs, ps)
    for lo in range(8, 13):
        for hi in range(lo, 13):
            assert_same_answer(rs.query(lo, hi, BETA), ps.query(lo, hi, BETA))
    assert ps.evict([9]) == [9]
    rs.evict([9])
    assert_same_answer(rs.query(10, 12, BETA), ps.query(10, 12, BETA))


def test_async_ingest_and_flush_match_sync():
    parts = partitions(4)
    sync = HistogramStore(num_buckets=T, device="cpu")
    sync.ingest_many(parts)
    asy = HistogramStore(num_buckets=T, async_ingest=True, device="cpu")
    try:
        for pid, v in parts.items():
            assert asy.ingest(pid, v) is None
        asy.flush()
        rs = R.HistogramStore(num_buckets=T)
        rs.ingest_many(parts)
        assert_same_store(rs, asy, len(parts))
        for a, b in zip(sync.query_many(windows(11), BETA), asy.query_many(windows(11), BETA)):
            assert_same_answer(a, b)
    finally:
        asy.close()


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_npz_save_in_one_package_loads_in_the_other(tmp_path, direction):
    parts = partitions(5)
    path = str(tmp_path / "store.npz")
    rs = R.HistogramStore(num_buckets=T, T_node="geometric", retention=R.SlidingWindow(20))
    ps = HistogramStore(num_buckets=T, T_node="geometric", retention=SlidingWindow(20), device="cpu")
    rs.ingest_many(parts)
    ps.ingest_many(parts)
    if direction == "reference_to_port":
        rs.save(path)
        loaded = HistogramStore.load(path, device="cpu")
        other = rs
    else:
        ps.save(path)
        loaded = R.HistogramStore.load(path)
        other = ps
    assert loaded.T_node == "geometric" and loaded.watermark == other.watermark
    assert loaded.retention.spec() == other.retention.spec()
    pairs = (rs, loaded) if direction == "reference_to_port" else (loaded, ps)
    assert_same_store(*pairs, len(parts))
    assert pairs[1]._tree.cache_misses > 0


def test_convert_store_from_reference_state():
    parts = partitions(6)
    rs = R.HistogramStore(num_buckets=T, T_node="geometric")
    rs.ingest_many(parts)
    meta, arrays = rs._state()
    ps = convert.store_from_reference(meta, arrays, device="cpu")
    assert ps.num_buckets == T and ps.T_node == "geometric"
    assert ps._tree.nodes.keys() == rs._tree.nodes.keys()
    for key, nd in rs._tree.nodes.items():  # pre-merged nodes carried, not re-merged
        assert np.array_equal(nd.boundaries, ps._tree.nodes[key].boundaries)
        assert nd.eps == ps._tree.nodes[key].eps
    assert_same_store(rs, ps, len(parts))
    # a bare _state() of an integer-T_node store needs num_buckets spelled out
    rs8 = R.HistogramStore(num_buckets=T, T_node=8)
    rs8.ingest_many(parts)
    ps8 = convert.store_from_reference(*rs8._state(), device="cpu", num_buckets=T)
    assert ps8.T_node == 8
    assert_same_store(rs8, ps8, len(parts))


def test_port_recovers_reference_written_wal(tmp_path):
    parts = partitions(7, count=6)
    wal_dir = str(tmp_path / "wal")
    rs = R.HistogramStore(num_buckets=T, wal_dir=wal_dir)
    try:
        for pid, v in parts.items():
            rs.ingest(pid, v)  # each ack fsynced to the log
    finally:
        rs.close()
    rec = HistogramStore.recover(str(tmp_path / "none.npz"), wal_dir, num_buckets=T, device="cpu")
    try:
        assert rec.last_recovery["replayed"] == 6
        assert_same_store(rs, rec, len(parts))
        rec.save(str(tmp_path / "snap.npz"))  # the port's checkpoint truncates the log
        again = R.HistogramStore.load(str(tmp_path / "snap.npz"), wal_dir=wal_dir)
        assert again.last_recovery["replayed"] == 0
        assert_same_store(again, rec, len(parts))
        again.close()
    finally:
        rec.close()


def test_int64_partition_matches_build_exact_not_the_reference_store():
    """The reference store pads an int64 partition with iinfo(int64).max
    and then narrows it to int32, which wraps the sentinel to -1.  The port
    narrows before padding and stores what build_exact gives."""
    v = np.arange(100, dtype=np.int64)[::-1]
    rs = R.HistogramStore(num_buckets=4)
    rs.ingest(0, v)
    ps = HistogramStore(num_buckets=4, device="cpu")
    ps.ingest(0, v)
    want = np.asarray(R.build_exact(jnp.asarray(v), 4).boundaries)
    np.testing.assert_array_equal(want, [0, 25, 50, 75, 99])
    np.testing.assert_array_equal(ps.summaries[0].boundaries, want)
    np.testing.assert_array_equal(rs.summaries[0].boundaries, [-1, -1, 22, 47, 71])


def host_stacked_summaries(parts: dict[int, np.ndarray], T: int) -> dict[int, tuple]:
    """The summaries of the store's earlier host path: each partition
    narrowed and padded by ``pad_pow2``, a group ``np.stack``ed to its
    common dtype (rows duplicated to a power of two), narrowed again."""
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
    groups = {}
    for pid, v in parts.items():
        v = v.astype(narrow.get(v.dtype, v.dtype))
        padded, n = pad_pow2(v)
        groups.setdefault(padded.shape[0], []).append((pid, padded, n))
    out = {}
    for rows in groups.values():
        k_pad = next_pow2(len(rows))
        stack = np.stack([r[1] for r in rows] + [rows[-1][1]] * (k_pad - len(rows)))
        stack = stack.astype(narrow.get(stack.dtype, stack.dtype))
        ns = [r[2] for r in rows] + [rows[-1][2]] * (k_pad - len(rows))
        h = build_exact_padded_batched(torch.from_numpy(stack), ns, T)
        for row, (pid, _, _) in enumerate(rows):
            out[pid] = (h.boundaries[row].numpy(), h.sizes[row].numpy())
    return out


def test_a_group_mixing_int32_and_float32_rows_matches_the_host_stack():
    """Rows of one padded length and two dtypes take float32, as
    ``np.stack`` and its narrowing gave them, bit for bit: int32 values
    near 2^31 round in the cast, and the int32 rows' sentinels become
    +inf where they were 2^31."""
    rng = np.random.default_rng(27)
    parts = {
        0: rng.integers(2**31 - 5000, 2**31 - 1, size=700, dtype=np.int64).astype(np.int32),
        1: (rng.gumbel(size=1000) * 10).astype(np.float32),
        2: rng.integers(-(2**31), 2**31 - 1, size=600, dtype=np.int64).astype(np.int32),
        3: rng.integers(0, 3, size=900).astype(np.int32),
        4: (rng.gumbel(size=1024) * 1e9).astype(np.float32),
    }
    ps = HistogramStore(num_buckets=T, device="cpu")
    ps.ingest_many(parts)
    assert ps.summarize_shapes == {(8, 1024, T)}
    want = host_stacked_summaries(parts, T)
    for pid, (b, sz) in want.items():
        got = ps.summaries[pid]
        assert got.boundaries.dtype == b.dtype == np.float32, pid
        assert np.array_equal(got.boundaries, b) and np.array_equal(got.sizes, sz), pid


def _read_only(v):
    v = v.copy()
    v.setflags(write=False)
    return v


@pytest.mark.parametrize(
    "make,copied",
    [(_read_only, False), (lambda v: v[::2], True), (lambda v: v[::-3], True)],
    ids=["read_only", "strided", "reversed"],
)
def test_read_only_and_non_contiguous_partitions_ingest_without_a_warning(make, copied, monkeypatch):
    """A read-only array is uploaded from where it lies, with no host copy
    and never handed to torch as read-only memory (torch warns about that
    once a process, so the test watches the handover itself); a
    non-contiguous one takes one contiguous host copy."""
    from_numpy = torch.from_numpy

    def checked(a):
        assert a.flags.writeable, "torch.from_numpy of a read-only array"
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", checked)
    v = make((np.random.default_rng(3).gumbel(size=3001) * 10).astype(np.float32))
    ps = HistogramStore(num_buckets=T, device="cpu")
    s0 = spans.snapshot()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ps.ingest(0, v)
    s1 = spans.snapshot()
    assert s1["ingest.host_copy_bytes"] - s0["ingest.host_copy_bytes"] == (v.nbytes if copied else 0)
    assert s1["ingest.upload_bytes"] - s0["ingest.upload_bytes"] == v.nbytes
    monkeypatch.undo()
    want = build_exact(np.ascontiguousarray(v), T, device="cpu")
    assert np.array_equal(ps.summaries[0].boundaries, want.boundaries.numpy())
    assert np.array_equal(ps.summaries[0].sizes, want.sizes.numpy())


def test_three_rows_padded_to_four_match_build_exact_row_by_row():
    rng = np.random.default_rng(5)
    parts = {p: (rng.gumbel(size=n) * 10).astype(np.float32) for p, n in enumerate([600, 1000, 777])}
    ps = HistogramStore(num_buckets=T, device="cpu")
    ps.ingest_many(parts)
    assert ps.summarize_shapes == {(4, 1024, T)}
    for pid, v in parts.items():
        want = build_exact(v, T, device="cpu")
        assert ps.summaries[pid].n == v.size
        assert np.array_equal(ps.summaries[pid].boundaries, want.boundaries.numpy()), pid
        assert np.array_equal(ps.summaries[pid].sizes, want.sizes.numpy()), pid


@pytest.mark.parametrize("collapse", ["canonical", "amortized"])
def test_collapse_modes_match_under_a_sliding_window(collapse):
    parts = partitions(8, count=13)
    kw = dict(num_buckets=T, T_node="geometric", collapse=collapse)
    rs = R.HistogramStore(retention=R.SlidingWindow(6), **kw)
    ps = HistogramStore(retention=SlidingWindow(6), device="cpu", **kw)
    for pid, v in parts.items():
        rs.ingest(pid, v)
        ps.ingest(pid, v)
    assert ps.ids() == list(range(7, 13))
    assert ps._tree.levels == rs._tree.levels and ps._tree.base == rs._tree.base
    for lo in range(7, 13):
        for hi in range(lo, 13):
            assert_same_answer(rs.query(lo, hi, BETA), ps.query(lo, hi, BETA))


def test_summary_loss_and_below_base_ingest_match():
    """The documented summary-loss idiom (``del store.summaries[pid]``,
    answered with ``strict=False``) and a partition id below the tree's
    base (a full rebase) take the same paths in both packages."""
    parts = partitions(9)
    rs = R.HistogramStore(num_buckets=T)
    ps = HistogramStore(num_buckets=T, device="cpu")
    late = {p: v for p, v in parts.items() if p >= 3}
    rs.ingest_many(late)
    ps.ingest_many(late)
    for store in (rs, ps):
        del store.summaries[6]
    for lo, hi in [(3, 10), (5, 7), (6, 6)]:
        ra = rs.query_many([(lo, hi)], BETA, strict=False)[0]
        pa = ps.query_many([(lo, hi)], BETA, strict=False)[0]
        if ra[0] is None:
            assert pa == (None, float("inf"))
        else:
            assert_same_answer(ra, pa)
    with pytest.raises(KeyError):
        ps.query(5, 7, BETA)
    rs.ingest(1, parts[1])
    ps.ingest(1, parts[1])
    assert_same_answer(rs.query(1, 10, BETA, strict=False), ps.query(1, 10, BETA, strict=False))
    # an externally built summary (a tensor histogram) is stored as is
    rs.ingest_summary(0, R.build_exact(jnp.asarray(parts[0]), 2))
    ps.ingest_summary(0, build_exact(torch.from_numpy(parts[0]), 2))
    assert_same_answer(rs.query(0, 4, BETA, strict=False), ps.query(0, 4, BETA, strict=False))


def test_device_gather_pack_equals_host_pack():
    from repro_torch.core import pack_device_rows, pack_node_rows

    ps = HistogramStore(num_buckets=T, device="cpu")
    ps.ingest_many(partitions(10, count=8))
    tree = ps._tree
    rows = [tree._selected(lo, hi) for lo, hi in [(0, 7), (2, 5), (6, 6), (1, 2)]]
    rows = [[nd for nd in r if nd.width == T] for r in rows]  # one plane
    hb, hs = pack_node_rows(rows, T_pad=T, pad_row_copy=True)
    db, ds = pack_device_rows(rows)
    assert np.array_equal(db.numpy(), hb) and np.array_equal(ds.numpy(), hs)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HistogramStore(num_buckets=T)
    assert HistogramStore(num_buckets=T, device="cpu").device == torch.device("cpu")
