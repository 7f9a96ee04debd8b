"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here skips without a card
(the fixture decides, at run time).  This file imports neither JAX nor
the reference package, so it runs on the GPU host as it is::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: bit-equal (``torch.equal``); the row sort compares NaN masks
and the non-NaN values, so ±0 compare equal.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import bucket_count, ref


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def test_cuda_row_sort_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.round(torch.randn((8, 3000), generator=g, device=cuda) * 5)
    x[:, :3] = torch.tensor([-0.0, float("nan"), 0.0], device=cuda)
    got, want = kernels.sort_rows(x), ref.sort_rows_ref(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])
    ns = [2997, 1, 17, 2048, 999, 2997, 5, 64]
    assert torch.equal(kernels.summarize_rows(x[:, 3:].contiguous(), ns, 16),
                       ref.summarize_rows_ref(x[:, 3:].contiguous(), ns, 16))


def test_cuda_kv_sort_exact_stable_order(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    keys = torch.randint(0, 9, (4, 10000), generator=g, device=cuda).float()
    vals = torch.arange(40000, device=cuda, dtype=torch.float32).reshape(4, 10000)
    for a, b in zip(kernels.sort_kv(keys, vals), ref.sort_kv_ref(keys, vals)):
        assert torch.equal(a, b)


def merge_cases(beta: int):
    """(name, bounds, sizes) on the CPU: 16 problems of 5 summaries with
    ties; the resident capacity's edges k(T+1) = 16,384 and 16,385; ±0,
    ±inf and NaN boundaries; n = 0 problems beside others; and β above
    k(T+1)."""
    rng = np.random.default_rng(beta)

    def summaries(Q, k, T, hi=5000):
        b = torch.sort(torch.from_numpy(rng.integers(0, 50, size=(Q, k, T + 1)).astype(np.float32)), -1).values
        n = rng.integers(T, hi, size=Q * k)
        s = torch.from_numpy(np.diff(ref.masked_cuts(n, T), axis=-1).astype(np.float32).reshape(Q, k, T))
        return b, s

    out = [("ties", *summaries(16, 5, 64))]
    out.append(("k(T+1) = 16,384", *summaries(3, 64, 255)))
    out.append(("k(T+1) = 16,385", *summaries(3, 5, 3276)))
    b, s = summaries(6, 4, 20)
    b[0, 0, -1], b[1, 1, 0], b[2, 2, 5:] = float("inf"), -float("inf"), float("nan")
    b[3, 0, :3] = torch.tensor([-0.0, 0.0, -0.0])
    s[4] = 0.0  # an empty query row packs to zero mass
    out.append(("non-finite, n = 0", b, s))
    out.append(("beta > k(T+1)", *summaries(4, 2, 3, hi=10)))
    return out


@pytest.mark.parametrize("regime", ["resident", "long"])
@pytest.mark.parametrize("beta", [1, 7, 64])
def test_cuda_merge_bit_equal(cuda, beta, regime):
    from repro_torch.kernels import merge_cut

    for name, b, s in merge_cases(beta):
        Q, k, T1 = b.shape
        if regime == "resident" and not merge_cut.plan(k, T1 - 1):
            continue  # past the resident capacity: the long regime only
        finite = bool(torch.isfinite(b).all())
        for bd in [b] + ([b.to(torch.int32)] if finite else []):
            want = ref.merge_ref(bd, s, beta)
            kernels.reset_launches()
            got = kernels.merge_batched(bd.to(cuda), s.to(cuda), beta, regime=regime)
            assert kernels.LAUNCHES["merge_cut"] == 1
            assert kernels.LAUNCHES["sort_kv"] == (regime == "long")
            for a, w in zip(got, want):
                assert a.dtype == w.dtype, name
                assert torch.equal(a.cpu().view(torch.int32), w.view(torch.int32)), (name, bd.dtype)


def test_cuda_resident_merge_stacks_is_one_launch(cuda):
    from repro_torch.core import merge_stacks

    rng = np.random.default_rng(11)
    b = np.sort(rng.normal(size=(9, 2, 33)), axis=-1).astype(np.float32)
    s = np.full((9, 2, 32), 3.0, np.float32)
    kernels.reset_launches()
    bo, so = merge_stacks(b, s, 32)
    assert kernels.LAUNCHES["merge_cut"] == 1 and kernels.LAUNCHES["sort_kv"] == 0
    want = ref.merge_ref(torch.from_numpy(b), torch.from_numpy(s), 32)
    assert torch.equal(bo.cpu(), want[0]) and torch.equal(so.cpu(), want[1])


@pytest.mark.parametrize("T_node", [None, "geometric"])
def test_cuda_store_bit_equal_to_cpu_store(cuda, T_node):
    from repro_torch.core import HistogramStore

    rng = np.random.default_rng(3)
    parts = {p: rng.gumbel(size=int(rng.integers(1, 3000))).astype(np.float32) for p in range(21)}
    parts[5] = rng.integers(-9, 9, size=500).astype(np.int64)  # stacked beside floats
    parts[6] = rng.integers(-9, 9, size=5000).astype(np.int64)  # a group of its own
    parts[7] = rng.normal(size=9000).astype(np.float16)
    stores = [HistogramStore(num_buckets=32, T_node=T_node, device=d) for d in (cuda, "cpu")]
    for st in stores:
        st.ingest_many(parts)
    for pid in parts:
        a, b = (st.summaries[pid] for st in stores)
        assert np.array_equal(a.boundaries, b.boundaries) and a.boundaries.dtype == b.boundaries.dtype
        assert np.array_equal(a.sizes, b.sizes)
    wins = [(lo, hi) for lo in range(21) for hi in range(lo, 21)]
    for (hg, eg), (hc, ec) in zip(*(st.query_many(wins, 7) for st in stores)):
        assert np.array_equal(hg.boundaries, hc.boundaries) and np.array_equal(hg.sizes, hc.sizes)
        assert eg == ec
    flat = [HistogramStore(num_buckets=32, engine="flat", device=d) for d in (cuda, "cpu")]
    for st in flat:
        st.ingest_many(parts)
    from repro_torch.core import build_exact

    for st in flat:  # a summary built on the card, stored as is
        st.ingest_summary(21, build_exact(torch.from_numpy(parts[0]).to(cuda), 32))
    for lo, hi in [(2, 19), (5, 5), (6, 7), (0, 21)]:
        (hg, eg), (hc, ec) = (st.query(lo, hi, 9) for st in flat)
        assert hg.boundaries.dtype == hc.boundaries.dtype
        assert np.array_equal(hg.boundaries, hc.boundaries) and np.array_equal(hg.sizes, hc.sizes)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64, np.int64])
def test_cuda_store_pads_on_the_card_as_the_cpu_store_does(cuda, dtype):
    """The sort's padded input, built in a sentinel-filled buffer on the
    card (rows uploaded as they lie, duplicated rows copied there), gives
    the CPU store's summaries bit for bit: tiny, unpadded, padded and
    grouped partitions, one at a time and in one batch, read-only and
    strided ones among them."""
    from repro_torch.core import HistogramStore, spans

    rng = np.random.default_rng(27)
    lens = [5, 1000, 1024, 700, 3001, 65_536, 40_000]
    if np.issubdtype(dtype, np.floating):
        parts = {p: (rng.gumbel(size=n) * 10).astype(dtype) for p, n in enumerate(lens)}
    else:
        parts = {p: rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(dtype)
                 for p, n in enumerate(lens)}
    parts[1].setflags(write=False)
    parts[7] = np.concatenate([parts[4], parts[4]])[::2]  # strided
    for batch in (True, False):
        stores = [HistogramStore(num_buckets=64, device=d) for d in (cuda, "cpu")]
        for st in stores:
            s0 = spans.snapshot()["ingest.upload_bytes"]
            if batch:
                st.ingest_many(parts)
            else:
                for pid, v in parts.items():
                    st.ingest(pid, v)
            real = sum(v.size for v in parts.values() if v.size >= 64) * 4
            assert spans.snapshot()["ingest.upload_bytes"] - s0 == real
        if batch:
            assert stores[0].summarize_shapes == stores[1].summarize_shapes
            assert (4, 1024, 64) in stores[0].summarize_shapes  # three rows and a copy
        for pid in parts:
            a, b = (st.summaries[pid] for st in stores)
            assert a.boundaries.dtype == b.boundaries.dtype, pid
            assert np.array_equal(a.boundaries, b.boundaries) and np.array_equal(a.sizes, b.sizes), pid
            assert a.crc == b.crc, pid


def test_cuda_async_ingest_launches_from_the_worker(cuda):
    from repro_torch.core import HistogramStore

    rng = np.random.default_rng(4)
    parts = {p: rng.normal(size=700).astype(np.float32) for p in range(9)}
    sync = HistogramStore(num_buckets=16, device="cpu")
    sync.ingest_many(parts)
    kernels.reset_launches()
    asy = HistogramStore(num_buckets=16, async_ingest=True, device=cuda)
    try:
        for pid, v in parts.items():
            asy.ingest(pid, v)
        asy.flush()
        assert kernels.LAUNCHES["tile_sort"] > 0 and kernels.LAUNCHES["merge_cut"] > 0
        for (ha, ea), (hs, es) in zip(asy.query_many([(0, 8), (3, 5)], 4), sync.query_many([(0, 8), (3, 5)], 4)):
            assert np.array_equal(ha.boundaries, hs.boundaries) and ea == es
    finally:
        asy.close()


@pytest.fixture
def small_ring(cuda, monkeypatch):
    """A fresh ring of three threads and five slots of 64 KiB, taking
    every row of 64 KiB or more: a test's rows of a few MB reuse each slot
    several times."""
    from repro_torch.core import pinned

    monkeypatch.setattr(pinned, "THREADS", 3)
    monkeypatch.setattr(pinned, "CHUNK_BYTES", 1 << 16)
    monkeypatch.setattr(pinned, "MIN_BYTES", 1 << 16)
    monkeypatch.setattr(pinned, "_RINGS", {})
    return pinned


def _ring_parts(dtype, seed: int) -> dict:
    """Rows of 2.8, 4.2 and 1.2 MB through the ring, one of 280 KB in
    fewer chunks than the ring has slots, one of 20 KB copied directly; a
    read-only and a strided one among them."""
    rng = np.random.default_rng(seed)
    lens = [700_001, 1 << 20, 300_000, 70_000, 5000]
    if np.issubdtype(dtype, np.floating):
        parts = {p: (rng.gumbel(size=n) * 10).astype(dtype) for p, n in enumerate(lens)}
    else:
        parts = {p: rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(dtype)
                 for p, n in enumerate(lens)}
    parts[1].setflags(write=False)
    parts[5] = np.concatenate([parts[0], parts[0]])[::2]
    return parts


def _same_summaries(a, b, pids):
    for pid in pids:
        x, y = a.summaries[pid], b.summaries[pid]
        assert x.boundaries.dtype == y.boundaries.dtype, pid
        assert np.array_equal(x.boundaries, y.boundaries) and np.array_equal(x.sizes, y.sizes), pid
        assert x.crc == y.crc, pid


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64, np.int64])
def test_cuda_pinned_ring_summaries_bit_equal_to_direct_copies(cuda, small_ring, monkeypatch, dtype):
    """Rows through the pinned ring (narrowed, read-only and strided ones
    among them, one at a time and in one batch) give the summaries of the
    direct copy on the card and of the CPU store, bit for bit, and count
    their bytes in ``ingest.pinned_bytes``."""
    from repro_torch.core import HistogramStore, spans

    parts = _ring_parts(dtype, 33)
    big = sum(v.size * 4 for v in parts.values() if v.size * 4 >= small_ring.MIN_BYTES)
    ring = [HistogramStore(num_buckets=64, device=cuda) for _ in range(2)]
    s0 = spans.snapshot()["ingest.pinned_bytes"]
    ring[0].ingest_many(parts)
    for pid, v in parts.items():
        ring[1].ingest(pid, v)
    assert spans.snapshot()["ingest.pinned_bytes"] - s0 == 2 * big
    assert len(small_ring._RINGS) == 1
    monkeypatch.setattr(small_ring, "MIN_BYTES", 1 << 62)
    direct, cpu = HistogramStore(num_buckets=64, device=cuda), HistogramStore(num_buckets=64, device="cpu")
    s0 = spans.snapshot()["ingest.pinned_bytes"]
    for st in (direct, cpu):
        st.ingest_many(parts)
    assert spans.snapshot()["ingest.pinned_bytes"] == s0
    for st in ring + [cpu]:
        _same_summaries(st, direct, parts)


@pytest.mark.parametrize("slowed", ["copy", "current"])
def test_cuda_pinned_ring_waits_for_a_slowed_stream(cuda, small_ring, slowed):
    """A copy stream held back by a sleep (the slots' DMAs queued behind
    it: a slot refilled before its DMA ran, or a sort that did not wait
    for the copies, would read other bytes; the 280 KB row's five chunks
    take a slot each, so only the sort's wait holds its sort back), or a
    current stream held back before the sentinel fill (a DMA that did not
    wait for the fill would be overwritten by it): the summaries stay
    exact."""
    from repro_torch.core import HistogramStore

    parts = _ring_parts(np.float32, 34)
    st, cpu = HistogramStore(num_buckets=64, device=cuda), HistogramStore(num_buckets=64, device="cpu")
    st.ingest(9, parts.pop(2))  # builds the ring
    ring = next(iter(small_ring._RINGS.values()))
    for pid, v in parts.items():
        with torch.cuda.stream(ring.stream if slowed == "copy" else torch.cuda.current_stream()):
            torch.cuda._sleep(100_000_000)  # about 50 ms at 1.98 GHz
        st.ingest(pid, v)
    cpu.ingest_many(parts)
    _same_summaries(st, cpu, parts)


def test_cuda_pinned_ring_two_threads_two_stores_at_once(cuda, small_ring):
    """Two threads ingest into two stores at once, taking turns on the one
    ring of the card; both stay exact."""
    import threading

    from repro_torch.core import HistogramStore

    jobs = [_ring_parts(np.float32, 35), _ring_parts(np.int32, 36)]
    stores = [HistogramStore(num_buckets=64, device=cuda) for _ in jobs]
    errors = []

    def run(st, parts):
        try:
            for _ in range(3):
                for pid, v in parts.items():
                    st.ingest(pid, v)
        except Exception as e:  # noqa: BLE001 - re-raised by the test below
            errors.append(e)

    threads = [threading.Thread(target=run, args=job) for job in zip(stores, jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(small_ring._RINGS) == 1
    for st, parts in zip(stores, jobs):
        cpu = HistogramStore(num_buckets=64, device="cpu")
        cpu.ingest_many(parts)
        _same_summaries(st, cpu, parts)


def test_cuda_pinned_ring_keeps_no_reference_to_the_callers_array(cuda, small_ring):
    """The caller's array is overwritten right after ``ingest`` returns:
    the stored summary and the month's answer are the original values'."""
    from repro_torch.core import HistogramStore

    parts = _ring_parts(np.float32, 37)
    keep = {pid: v.copy() for pid, v in parts.items()}
    st = HistogramStore(num_buckets=64, device=cuda)
    for pid, v in parts.items():
        w = v.copy()
        st.ingest(pid, w)
        w[:] = -1.0
    torch.cuda.synchronize()
    cpu = HistogramStore(num_buckets=64, device="cpu")
    cpu.ingest_many(keep)
    _same_summaries(st, cpu, parts)
    (hg, eg), (hc, ec) = st.query(0, 5, 16), cpu.query(0, 5, 16)
    assert np.array_equal(hg.boundaries, hc.boundaries) and np.array_equal(hg.sizes, hc.sizes) and eg == ec


def test_cuda_pinned_ring_at_its_own_sizes(cuda, monkeypatch):
    """The ring as the store builds it (its own chunk, slots and threads):
    a row of three chunks and a tail, summarized as the CPU store does."""
    from repro_torch.core import HistogramStore, pinned, spans

    monkeypatch.setattr(pinned, "_RINGS", {})
    n = (3 * pinned.CHUNK_BYTES + 4 * 7) // 4
    v = (np.random.default_rng(38).gumbel(size=n) * 10).astype(np.float32)
    st, cpu = HistogramStore(num_buckets=2032, device=cuda), HistogramStore(num_buckets=2032, device="cpu")
    s0 = spans.snapshot()["ingest.pinned_bytes"]
    st.ingest(0, v)
    assert spans.snapshot()["ingest.pinned_bytes"] - s0 == v.nbytes
    cpu.ingest(0, v)
    _same_summaries(st, cpu, [0])


def test_cuda_pre_histogram_and_empirical_sizes_match_cpu(cuda):
    from repro_torch.core import Histogram, build_exact, empirical_sizes, merge, pre_histogram

    rng = np.random.default_rng(5)
    v = rng.integers(0, 40, size=5000).astype(np.float32)  # heavy ties
    hs = [build_exact(part, 24, device="cpu") for part in np.split(v, 5)]
    h = Histogram(torch.stack([x.boundaries for x in hs]), torch.stack([x.sizes for x in hs]))
    hd = Histogram(h.boundaries.to(cuda), h.sizes.to(cuda))
    for a, b in zip(pre_histogram(hd), pre_histogram(h)):
        assert torch.equal(a.cpu(), b)
    m = merge(h, 9)
    got = empirical_sizes(torch.from_numpy(v).to(cuda), m.boundaries.to(cuda))
    assert torch.equal(got.cpu(), empirical_sizes(v, m.boundaries))


def bucket_cases(seed: int = 7):
    """(name, values, boundaries, offset) on the CPU: ties, NaN/±inf/±0,
    b_T = +inf, int32 above 2^24, NaN boundaries, T+1 in {2, 33, 255, 2049},
    one T+1 that needs more than 48 KB of shared memory, the largest that
    fits it (``bucket_count.SHARED_MAX_T1``) and the next, and two wider (one
    and three passes over the slots), n in {0, 1, 3, 4, 5, 17, 5000, 2^20 + 3}; searched prefixes at the
    edges of the BFS table's depth (m in {0, 1, 2^k - 1, 2^k, 2^k + 1} for
    k = 5, 8, 11); streams that start 1, 2 or 3 floats past a 16-byte
    boundary (``offset``); a stream of one value, one of b_T only and a
    sorted one."""
    rng = np.random.default_rng(seed)
    out = []
    for m in (0, 1, 31, 32, 33, 255, 256, 257, 2047, 2048, 2049):
        x = np.round(rng.normal(size=5000) * 4).astype(np.float32)
        x[:4] = [np.nan, np.inf, -np.inf, -0.0]
        b = np.sort(np.round(rng.normal(size=m) * 4)).astype(np.float32)
        for pad in {max(2 - m, 0), 3}:
            out.append((f"m={m} pad={pad}", x, np.concatenate([b, [np.nan] * pad]).astype(np.float32), 0))
    b33 = np.sort(rng.normal(size=33)).astype(np.float32)
    for off in (0, 1, 2, 3):
        for n in (3, 4, 5, 17, 70_001):
            out.append((f"n={n} offset={off}", rng.normal(size=n).astype(np.float32), b33, off))
    b255 = np.sort(np.round(rng.normal(size=255) * 8)).astype(np.float32)
    spread = rng.normal(size=70_003).astype(np.float32) * 8
    out.append(("one value", np.full(70_003, b255[100], np.float32), b255, 0))
    out.append(("all b_T", np.full(70_003, b255[-1], np.float32), b255, 1))
    out.append(("sorted", np.sort(spread), b255, 0))
    for T1 in (2, 33, 255, 2049):
        for n in (0, 1, 5000, (1 << 20) + 3):
            x = np.round(rng.normal(size=n) * 4).astype(np.float32)
            b = np.sort(np.round(rng.normal(size=T1) * 4)).astype(np.float32)  # ties
            out.append((f"T+1={T1} n={n}", x, b, 0))
    x = rng.normal(size=70_000).astype(np.float32)
    x[rng.integers(0, x.size, 4000)] = rng.choice(
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32), 4000
    )
    b = np.sort(np.concatenate([rng.normal(size=30), [-0.0, 0.0, 0.0]])).astype(np.float32)
    out.append(("NaN/inf/±0 values", x, b, 0))
    out.append(("b_T = +inf", x, np.concatenate([b[:-1], [np.inf]]).astype(np.float32), 0))
    out.append(("b_0 = -inf", x, np.concatenate([[-np.inf], b[1:]]).astype(np.float32), 0))
    out.append(("NaN boundaries", x, np.concatenate([b[:20], [np.nan] * 13]).astype(np.float32), 0))
    xi = rng.integers(2**24, 2**31 - 1, size=100_000, dtype=np.int32)
    bi = np.sort(rng.integers(2**24, 2**31 - 1, size=65)).astype(np.float32)
    out.append(("int32 above 2^24", xi, bi, 0))
    out.append(("T+1=20001 (shared above 48 KB)", x, np.sort(rng.normal(size=20_001)).astype(np.float32), 0))
    out.append(("T+1=40001 (global)", x, np.sort(rng.normal(size=40_001)).astype(np.float32), 0))
    for T1 in (bucket_count.SHARED_MAX_T1, bucket_count.SHARED_MAX_T1 + 1):  # the last shared, the first global
        out.append((f"T+1={T1}", x, np.sort(rng.normal(size=T1)).astype(np.float32), 0))
    out.append(("T+1=150001 (global, three passes)", x, np.sort(rng.normal(size=150_001)).astype(np.float32), 0))
    return out


def test_cuda_bucket_count_matches_plain(cuda):
    for name, x, b, off in bucket_cases():
        xd = torch.from_numpy(np.concatenate([np.zeros(off, np.float32), x]).astype(x.dtype)).to(cuda)[off:]
        bd = torch.from_numpy(b).to(cuda)
        kernels.reset_launches()
        got = kernels.cumulative_counts(xd, bd)
        assert kernels.LAUNCHES["bucket_count"] == 1, name
        assert got.device.type == "cuda" and got.dtype == torch.float32
        want = ref.cumulative_counts_ref(torch.from_numpy(x), torch.from_numpy(b))
        assert torch.equal(got.cpu(), want), name
        assert torch.equal(ref.cumulative_counts_ref(xd, bd).cpu(), want), name
        sizes = kernels.bucket_sizes(xd, bd)
        assert torch.equal(sizes.cpu(), kernels.bucket_sizes(x, b, device="cpu")), name


def test_cuda_bucket_count_rejects_unsorted_boundaries(cuda):
    x = torch.ones(10, device=cuda)
    for b in ([0.0, 2.0, 1.0], [0.0, float("nan"), 1.0]):
        with pytest.raises(ValueError):
            kernels.cumulative_counts(x, torch.tensor(b, device=cuda))


def test_cuda_summarize_tiles_matches_cpu(cuda):
    rng = np.random.default_rng(8)
    for n in (1, 4096, 3 * 4096 + 517):
        x = rng.lognormal(-1.8, 0.55, size=n).astype(np.float32)
        kernels.reset_launches()
        hg = kernels.summarize_tiles(x, tile_len=1024, T_tile=64, T_out=128)
        assert kernels.LAUNCHES["tile_sort"] == 1 and kernels.LAUNCHES["merge_cut"] == 1
        hc = kernels.summarize_tiles(x, tile_len=1024, T_tile=64, T_out=128, device="cpu")
        assert hg.boundaries.device.type == "cuda"
        assert torch.equal(hg.boundaries.cpu(), hc.boundaries)
        assert torch.equal(hg.sizes.cpu(), hc.sizes)


def test_cuda_numpy_input_runs_on_the_card(cuda):
    from repro_torch.core import TenantRegistry, build_exact, merge_stacks

    rng = np.random.default_rng(9)
    v = rng.normal(size=5000).astype(np.float32)
    assert build_exact(v, 16).boundaries.device.type == "cuda"
    b = np.sort(rng.normal(size=(2, 3, 17)), axis=-1).astype(np.float32)
    s = np.full((2, 3, 16), 4.0, np.float32)
    kernels.reset_launches()
    bo, so = merge_stacks(b, s, 5)
    assert bo.device.type == "cuda" and kernels.LAUNCHES["merge_cut"] == 1
    assert kernels.bucket_sizes(v, np.sort(v)[::500]).device.type == "cuda"
    assert TenantRegistry(num_buckets=8).device.type == "cuda"


def test_cuda_registry_round_one_merge_bit_equal_to_cpu(cuda):
    from repro_torch.core import TenantRegistry

    rng = np.random.default_rng(10)
    data = {f"t{t}": {d: rng.gumbel(size=3000).astype(np.float32) for d in range(9)} for t in range(6)}
    regs = [TenantRegistry(num_buckets=32, shared_arena=True, device=d) for d in (cuda, "cpu")]
    for reg in regs:
        for name, parts in data.items():
            for d, v in parts.items():
                reg.ingest_async(name, d, v)
        reg.flush()
    qs = [(name, 0, 8) for name in data] + [("t2", 3, 5), ("t4", 1, 7)]
    kernels.reset_launches()
    regs[0].merge_dispatches = 0
    regs[0].reset_host_row_copies()
    got = regs[0].query_many(qs, 7)
    assert regs[0].merge_dispatches == 1 and regs[0].host_row_copies == 0
    assert kernels.LAUNCHES["merge_cut"] == 1
    for (hg, eg), (hc, ec) in zip(got, regs[1].query_many(qs, 7)):
        assert np.array_equal(hg.boundaries, hc.boundaries) and np.array_equal(hg.sizes, hc.sizes)
        assert eg == ec
    for reg in regs:
        reg.close()


def regime_widths():
    """(kv, width, regime) at each regime boundary: one below, at and one
    past each resident limit, both regimes forced around a onesweep tile,
    ragged widths and width 1."""
    from repro_torch.kernels import tile_sort

    out = []
    for kv, limit in ((False, tile_sort.ROW_RESIDENT_LIMIT), (True, tile_sort.KV_RESIDENT_LIMIT)):
        for w in (1, 3, 255, 257, 3001, limit - 1, limit, limit + 1, 70_001):
            out.append((kv, w, None))
        for w in (1, 4096, 8191, 8193):
            out.append((kv, w, "onesweep"))
        for w in (1, 513, 8192):
            out.append((kv, w, "resident"))
    return out


def regime_rows(cuda, width: int, seed: int):
    """Rows of one width: ties with ±0, NaN and ±inf; all-equal; int32."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.round(torch.randn((3, width), generator=g, device=cuda) * 4)
    special = torch.tensor([-0.0, 0.0, float("nan"), float("inf"), -float("inf")], device=cuda)
    at = torch.randint(0, width, (3, max(1, width // 8)), generator=g, device=cuda)
    x.scatter_(1, at, special[torch.randint(0, 5, at.shape, generator=g, device=cuda)])
    x[1] = 7.0  # a row of one key
    xi = torch.randint(-50, 50, (2, width), generator=g, device=cuda, dtype=torch.int32)
    xi[0, : min(width, 3)] = torch.tensor([-(2**31), 2**31 - 1, 0], dtype=torch.int32)[: min(width, 3)]
    return [x, xi]


@pytest.mark.parametrize("kv,width,regime", regime_widths())
def test_cuda_sorts_at_regime_boundaries(cuda, kv, width, regime):
    for x in regime_rows(cuda, width, width + kv):
        if not kv:
            got, want = kernels.sort_rows(x, regime=regime), ref.sort_rows_ref(x)
            if x.is_floating_point():
                nan = torch.isnan(want)
                assert torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])
            else:
                assert torch.equal(got, want)
            if regime is None:
                ns = [width, max(1, width // 3)] + [1] * (x.shape[0] - 2)
                T = 16 if width > 16 else 1
                a, w = kernels.summarize_rows(x, ns, T), ref.summarize_rows_ref(x, ns, T)
                nan = torch.isnan(w)
                assert torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], w[~nan])
            continue
        vals = torch.arange(x.numel(), device=cuda, dtype=torch.int32).reshape(x.shape)
        ko, vo = kernels.sort_kv(x, vals, regime=regime)
        rk, rv = ref.sort_kv_ref(x, vals)
        assert torch.equal(vo, rv)  # the exact stable order
        assert torch.equal(ko.view(torch.int32), rk.view(torch.int32))  # and the key bits
        L = 1 << max(0, width - 1).bit_length()
        for Lp in (L, 2 * L):
            pairs = kernels.argsort_pairs(x, Lp, regime=regime)
            assert torch.equal(pairs, ref.argsort_pairs_ref(x, Lp)), Lp


def test_cuda_summarize_tiles_nan_and_inf_match_cpu(cuda):
    """NaN, ±inf and ±0 in the stream: the card's tile Summarizer gives the
    CPU run's sizes bit for bit and its boundaries in value with one NaN
    mask (NaN sort last as one key, so a tile holding NaN ends in NaN
    boundaries on both sides).  Bits differ only where the row sort writes
    its one NaN for any NaN and +0 for -0 (``tile_sort.sort_rows``)."""
    rng = np.random.default_rng(12)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
    for n, share in ((4096, 0.01), (3 * 4096 + 517, 0.2), (2 * 4096, 1.0)):
        x = rng.lognormal(-1.8, 0.55, size=n).astype(np.float32)
        at = rng.random(n) < share
        x[at] = rng.choice(special, int(at.sum()))
        hg = kernels.summarize_tiles(x, tile_len=1024, T_tile=64, T_out=128, device=cuda)
        hc = kernels.summarize_tiles(x, tile_len=1024, T_tile=64, T_out=128, device="cpu")
        assert torch.equal(hg.sizes.cpu().view(torch.int32), hc.sizes.view(torch.int32)), n
        a, b = hg.boundaries.cpu(), hc.boundaries
        nan = torch.isnan(b)
        assert a.dtype == b.dtype and torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan]), n
        differ = a.view(torch.int32) != b.view(torch.int32)
        assert bool(((torch.isnan(a) & nan) | ((a == 0) & (b == 0)))[differ].all()), n


def test_cuda_subscription_tick_is_one_merge_launch_bit_equal_to_cpu(cuda):
    """One tick across six tenants: one merge dispatch, one ``merge_cut``
    launch (from the plane's worker thread), and pushes bit-equal to the
    same run on the CPU, as host arrays."""
    from repro_torch.core import TenantRegistry
    from repro_torch.serve import SubscriptionPlane

    rng = np.random.default_rng(13)
    names = [f"t{i}" for i in range(6)]
    data = {n: {d: rng.lognormal(-1.8, 0.55, size=2000).astype(np.float32) for d in range(5)} for n in names}
    runs = []
    for dev in (cuda, "cpu"):
        reg = TenantRegistry(num_buckets=32, shared_arena=True, device=dev)
        plane = SubscriptionPlane(reg)
        subs = [plane.subscribe(n, lo, 3, 16) for n in names for lo in (0, 2)]
        subs += [plane.subscribe(n, 0, 3, 16) for n in names]  # shared windows
        for n in names:
            for d in range(4):
                reg.tenant(n).ingest(d, data[n][d])
        plane.flush()
        for n in names:  # store-level: versions move, no ticks
            reg.tenant(n).ingest(4, data[n][4])
        kernels.reset_launches()
        d0, b0 = reg.merge_dispatches, plane.stats()["eval_batches"]
        plane.mark_stale(names)  # ONE tick covering all six tenants
        plane.flush()
        launches = kernels.reset_launches()
        assert reg.merge_dispatches - d0 == 1 and plane.stats()["eval_batches"] - b0 == 1
        if dev == cuda:
            assert launches["merge_cut"] == 1 and launches["tile_sort"] == 0, launches
        runs.append([sub.drain()[-1] for sub in subs])
        plane.close()
        reg.close()
    for ug, uc in zip(*runs):
        assert isinstance(ug.hist.boundaries, np.ndarray) and not ug.degraded
        assert np.array_equal(ug.hist.boundaries, uc.hist.boundaries)
        assert np.array_equal(ug.hist.sizes, uc.hist.sizes) and ug.eps == uc.eps
        assert ug.version == uc.version


def test_cuda_primary_replica_promote_cycle(cuda, tmp_path):
    """A card primary ships to a card replica: after ``sync`` the replica's
    answers are bit-equal to the primary's and to a CPU replica's, zero
    drift, not degraded; ``promote`` fences the primary, and the promoted
    service records on the card."""
    from repro_torch.core import PrimaryFenced
    from repro_torch.serve import HistogramService

    rng = np.random.default_rng(14)
    pdir, sdir = str(tmp_path / "primary"), str(tmp_path / "standby")
    svc = HistogramService(pdir, num_buckets=32, shared_arena=True, replicate_to=[sdir], device=cuda)
    for m in ("a", "b"):
        for d in range(6):
            svc.record_async(m, d, rng.lognormal(-1.8, 0.55, size=3000).astype(np.float32))
    svc.flush()
    svc.record("c", 0, rng.normal(size=500).astype(np.float32))
    qs = [(m, lo, hi) for m in ("a", "b") for lo in range(6) for hi in range(lo, 6)] + [("c", 0, 0)]
    rep = HistogramService(sdir, role="replica", num_buckets=32, shared_arena=True, device=cuda)
    kernels.reset_launches()
    rep.sync()
    cpu = HistogramService(str(tmp_path / "cpu"), role="replica", num_buckets=32, device="cpu")
    for name in os.listdir(os.path.join(sdir, "wal")):  # the same shipped bytes
        shutil.copy(os.path.join(sdir, "wal", name), os.path.join(str(tmp_path / "cpu"), "wal", name))
    cpu.sync()
    got, want, oncpu = rep.query_many(qs, 16), svc.query_many(qs, 16), cpu.query_many(qs, 16)
    assert kernels.LAUNCHES["merge_cut"] > 0
    assert rep.follower.drift_by_tenant() == {"a": 0, "b": 0, "c": 0}
    for (hg, eg), (hp, ep), (hc, ec), a in zip(got, want, oncpu, got):
        assert not a.degraded
        for h in (hp, hc):
            assert np.array_equal(hg.boundaries, h.boundaries) and np.array_equal(hg.sizes, h.sizes)
        assert eg == ep == ec
    rep.promote(fence=svc.replicator.fence)
    rep.record("a", 6, rng.normal(size=800).astype(np.float32))
    assert rep.registry["a"].ids() == list(range(7))
    with pytest.raises(PrimaryFenced):
        svc.record("a", 6, rng.normal(size=800).astype(np.float32))
    for s in (rep, cpu, svc):
        s.close()


@pytest.fixture
def nccl_world_1(cuda, tmp_path):
    """An NCCL process group of one rank on the card (a FileStore
    rendezvous): NCCL puts no two ranks on one card, so the multi-rank
    cases run on gloo in tests/test_torch_distributed.py."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_cuda_distributed_world_1_bit_equal_to_cpu(cuda, nccl_world_1):
    """distributed_histogram, the hierarchical merge (tile rows resident,
    a long device-level merge) and tensor_histogram_in_step on an NCCL
    mesh of one card, bit-equal to the world-1 composition on the CPU."""
    from repro_torch.core import (
        Histogram, distributed_histogram, distributed_histogram_hierarchical,
        hierarchical_device_summary, local_summarize, merge, tensor_histogram_in_step,
    )
    from repro_torch.launch.mesh import make_mesh

    x = np.random.default_rng(15).gumbel(size=(1 << 20) + 123).astype(np.float32)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(cuda)
    one = lambda h, beta: merge(Histogram(h.boundaries[None], h.sizes[None]), beta)
    mesh = make_mesh((1,), ("data",))
    pods = make_mesh((1, 1), ("pod", "data"))
    kernels.reset_launches()
    got = [
        distributed_histogram(xg, 1024, 64, mesh),
        distributed_histogram_hierarchical(xg, pods, tile_size=1024, T_tile=128, T_device=512, T_pod=256, beta=64),
        tensor_histogram_in_step(xg, 256, 32, mesh, ("data",)),
    ]
    launches = kernels.reset_launches()
    want = [
        one(local_summarize(xc, 1024), 64),
        one(one(hierarchical_device_summary(xc, 1024, 128, 512), 256), 64),
        one(local_summarize(xc, 256), 32),
    ]
    for g, w in zip(got, want):
        assert g.boundaries.device.type == "cuda"
        assert torch.equal(g.boundaries.cpu(), w.boundaries) and torch.equal(g.sizes.cpu(), w.sizes)
    assert launches["tile_sort"] >= 3 and launches["sort_kv"] >= 1 and launches["merge_cut"] >= 5, launches


def grad_leaves(cuda, seed: int = 16):
    """40 leaves of seeded gradients (40 × 257 boundaries: a long merge)."""
    rng = np.random.default_rng(seed)
    tree = {f"layer{i:02d}": (rng.standard_t(4, size=(96, 70)) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
            for i in range(40)}
    return {k: torch.from_numpy(v) for k, v in tree.items()}, {k: torch.from_numpy(v).to(cuda) for k, v in tree.items()}


def test_cuda_training_plane_runs_without_host_sync_and_matches_cpu(cuda):
    """grad_quantile, quantile clipping, compression and an AdamW step on
    the card call nothing that waits for the device (sync debug mode
    "error"); threshold, clipped and split gradients bit-equal to the CPU,
    the step close to it."""
    from repro_torch.core.telemetry import grad_quantile
    from repro_torch.optim import (
        CompressionConfig, OptimizerConfig, adamw_update, clip_grads, compress_grads,
        init_opt_state, init_residual,
    )

    cpu, gpu = grad_leaves(cuda)
    cfg = OptimizerConfig(clip_mode="quantile", clip_q=0.99, clip_hist_T=256, peak_lr=1e-3, warmup_steps=2)
    ccfg = CompressionConfig(enabled=True, rho=0.01, hist_T=256)
    runs = {}
    for name, g in (("cpu", cpu), ("gpu", gpu)):
        grad_quantile(g, 0.99, 256)  # builds the kernels before the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            thr = grad_quantile(g, 0.99, 256)
            clipped, m = clip_grads(g, cfg)
            params, state, _ = adamw_update(clipped, init_opt_state(g, cfg), g, cfg)
            sparse, resid, cm = compress_grads(g, init_residual(g), ccfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs[name] = (thr, clipped, params, sparse, resid, cm["compress_threshold"])
    (t0, c0, p0, s0, r0, ct0), (t1, c1, p1, s1, r1, ct1) = runs["cpu"], runs["gpu"]
    assert t1.device.type == "cuda" and t1.dim() == 0
    assert torch.equal(t1.cpu(), t0) and torch.equal(ct1.cpu(), ct0)
    for k in cpu:
        assert torch.equal(c1[k].cpu(), c0[k]) and torch.equal(s1[k].cpu(), s0[k]) and torch.equal(r1[k].cpu(), r0[k])
        torch.testing.assert_close(p1[k].cpu(), p0[k], rtol=1e-6, atol=1e-7)


def test_cuda_length_bucketer_bit_equal_to_cpu(cuda):
    from repro_torch.data import LengthBucketer, SyntheticLM

    data = SyntheticLM(vocab_size=1000, seq_len=2048, global_batch=1, seed=17)
    rng = np.random.default_rng(17)
    shards = [data.doc_lengths(rng, 1 << 16) for _ in range(64)]  # 64 × 257: a long merge
    kernels.reset_launches()
    got = LengthBucketer(8, 256).fit(shards)
    launches = kernels.reset_launches()
    want = LengthBucketer(8, 256, device="cpu").fit(shards)
    assert got.merged_.boundaries.device.type == "cuda"
    assert got.boundaries_.tobytes() == want.boundaries_.tobytes()
    assert torch.equal(got.merged_.sizes.cpu(), want.merged_.sizes)
    assert launches["tile_sort"] == 64 and launches["sort_kv"] == 1 and launches["merge_cut"] == 1, launches


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b"])
def test_cuda_model_path_matches_cpu_at_smoke_width(cuda, arch):
    """forward_hidden, prefill, decode_step and greedy generate on the card
    against the CPU run of the same parameters (float32; logits within
    atol=rtol=1e-4, greedy tokens equal teacher-forced wherever the CPU's
    top-2 margin exceeds 2e-4)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import decode_step, forward_hidden, init_cache, init_model, prefill
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_map

    cfg = smoke(get_config(arch))
    cpu = init_model(cfg, torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    runs = {}
    with torch.no_grad():
        for name, p, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, cuda)):
            h, _ = forward_hidden(cfg, p, {"tokens": toks[:, :40]})
            lp, cache = prefill(cfg, p, {"tokens": toks[:, :40]}, init_cache(cfg, 2, 48, torch.float32, dev))
            ld, _ = decode_step(cfg, p, cache, toks[:, 40:], 40)
            runs[name] = [t.cpu() for t in (h, lp, ld)]
    for a, b in zip(runs["gpu"], runs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    prompts = [toks[0, :n] for n in (7, 19, 33)]
    want = Engine(cfg, cpu, ServeConfig(max_seq=48, max_new_tokens=8), device="cpu").generate(prompts)
    eng = Engine(cfg, gpu, ServeConfig(max_seq=48, max_new_tokens=8))
    assert eng.device.type == "cuda"
    got = eng.generate(prompts)
    # teacher-forced: the card's argmax is the CPU's token wherever the margin allows
    padded, _ = eng._pad_batch(prompts)
    L = padded.shape[1]
    with torch.no_grad():
        logits, cache = prefill(cfg, gpu, {"tokens": padded}, init_cache(cfg, 3, 48, torch.float32, cuda))
        for step in range(8):
            last = logits[:, -1].cpu()
            top = torch.topk(last, 2).values
            fed = np.zeros((3, 1), np.int32)
            for i, (w, p) in enumerate(zip(want, prompts)):
                if step < len(w) - len(p):
                    fed[i, 0] = int(w[len(p) + step])
                    if float(top[i, 0] - top[i, 1]) > 2e-4:
                        assert int(torch.argmax(last[i])) == fed[i, 0], (i, step)
            logits, cache = decode_step(cfg, gpu, cache, fed, L + step)
    assert all(len(g) == len(w) for g, w in zip(got, want))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 unit in the last place of each value of ``x`` (0 at 0)."""
    x = x.float()
    _, e = torch.frexp(x)  # |x| in [2^(e-1), 2^e)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


DECODE_CASES = [  # (name, B, Smax, Hkv, G, hd, cache dtype, q dtype, position, window, cap, q scale)
    *[(f"cell shape at {p}", 8, 1152, 8, 4, 128, torch.bfloat16, torch.bfloat16, p, None, None, 1.0)
      for p in (0, 1, 1023, 1151, 1200)],
    ("gemma2 local", 2, 4200, 8, 2, 256, torch.bfloat16, torch.bfloat16, 4150, 4096, 50.0, 8.0),
    ("dbrx G 6", 4, 600, 8, 6, 128, torch.bfloat16, torch.bfloat16, 517, None, None, 1.0),
    ("smollm hd 64 G 3", 4, 600, 3, 3, 64, torch.bfloat16, torch.bfloat16, 599, None, None, 1.0),
    ("hd 64 MHA float32", 3, 700, 4, 1, 64, torch.float32, torch.float32, 650, None, None, 1.0),
    ("bfloat16 q, float32 cache", 4, 576, 8, 4, 128, torch.float32, torch.bfloat16, 300, None, None, 1.0),
    ("smoke width", 2, 48, 2, 2, 32, torch.float32, torch.float32, 40, 32, None, 1.0),
]


def decode_inputs(cuda, case):
    """``(q, k, v)`` of one ``DECODE_CASES`` entry, drawn on the card."""
    _, B, Smax, Hkv, G, hd, kv_dtype, dtype, position, window, cap, scale = case
    g = torch.Generator(device=cuda).manual_seed(position + hd)
    q = (torch.randn((B, 1, Hkv, G, hd), generator=g, device=cuda) * scale).to(dtype)
    k = torch.randn((B, Smax, Hkv, hd), generator=g, device=cuda).to(kv_dtype)
    v = torch.randn((B, Smax, Hkv, hd), generator=g, device=cuda).to(kv_dtype)
    return q, k, v


def assert_decode_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """The kernel's tolerance against the plain body (the docstring of
    ``test_cuda_decode_attention_matches_plain``)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        excess = (got.float() - want.float()).abs() - bf16_ulp(want)
        assert float(excess.max()) <= 1e-5


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_cuda_decode_attention_matches_plain(cuda, case):
    """The decode attention kernel against the plain float32 body on the
    same card tensors, one launch count a call.  Tolerance: float32
    outputs within atol = rtol = 1e-5; bfloat16 outputs within one
    bfloat16 ulp of the plain output plus the same atol 1e-5.  Both compute
    the same float32 scores, softmax and PV product from the same values,
    so only the order of the sums differs (and the plain path's ``-1e30``
    weights are exactly 0): two float32 results a sum-order error apart
    round to bfloat16 values at most that error plus one ulp apart, and
    near zero, where a PV sum cancels, that error is many bfloat16 ulps."""
    from repro_torch.models import common

    dtype, position, window, cap = case[7:11]
    q, k, v = decode_inputs(cuda, case)
    before = kernels.LAUNCHES["decode_attention"]
    got = common.decode_attention(q, k, v, position, window=window, logit_cap=cap)
    assert kernels.LAUNCHES["decode_attention"] == before + 1
    want = common.plain_decode_attention(q, k, v, position, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert_decode_close(got, want)
    if position == 0:  # one visible position: its values, exactly
        assert torch.equal(got, v[:, :1, :, None, :].expand_as(got).to(dtype))


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_cuda_decode_attention_reads_a_device_position(cuda, case):
    """The kernel with its position as an int32 tensor on the card: the
    output of the host ``int`` bit for bit (one split layout a shape), and
    so the plain body's within the kernel's tolerance."""
    from repro_torch.models import common

    position, window, cap = case[8:11]
    q, k, v = decode_inputs(cuda, case)
    pos = torch.tensor([position], dtype=torch.int32, device=cuda)
    got = common.decode_attention(q, k, v, pos, window=window, logit_cap=cap)
    assert torch.equal(got, common.decode_attention(q, k, v, position, window=window, logit_cap=cap))
    assert_decode_close(got, common.plain_decode_attention(q, k, v, pos, window=window, logit_cap=cap))


@pytest.mark.parametrize("window", [None, 300])
def test_cuda_decode_attention_graph_serves_every_position(cuda, window):
    """One kernel call captured in a CUDA graph, replayed as the position
    it reads advances on the card: the plain body's output at each
    position, the first, split boundaries, the last slot and past it."""
    from repro_torch.kernels import gqa_decode
    from repro_torch.models import common

    case = ("graph", 8, 1152, 8, 4, 128, torch.bfloat16, torch.bfloat16, 5, window, None, 1.0)
    q, k, v = decode_inputs(cuda, case)
    pos = torch.zeros((), dtype=torch.int32, device=cuda)  # 0-d, as the engine holds it
    gqa_decode.decode_attention(q, k, v, pos, window=window)  # loads the library outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gqa_decode.decode_attention(q, k, v, pos, window=window)
    for position in (0, 1, 31, 383, 384, 767, 1000, 1151, 1300):
        pos.fill_(position)
        graph.replay()
        assert_decode_close(out.clone(), common.plain_decode_attention(q, k, v, position, window=window))


def test_cuda_decode_step_launches_decode_attention_once_a_layer(cuda):
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import decode_step, init_cache, init_model, prefill
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke(get_config("qwen3-8b")), repeats=3)
    params = tree_map(lambda t: t.to(cuda), init_model(cfg, torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    attn = sum(1 for _ in range(cfg.repeats) for kind in cfg.pattern if "attn" in kind)
    with torch.no_grad():
        _, cache = prefill(cfg, params, {"tokens": toks[:, :8]}, init_cache(cfg, 2, 16, torch.float32, cuda))
        kernels.reset_launches()
        decode_step(cfg, params, cache, toks[:, 8:], 8)
    assert attn >= 1 and kernels.reset_launches()["decode_attention"] == attn


SERVED = ["qwen3-8b", "gemma2-9b", "dbrx-132b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-medium", "pixtral-12b"]


def served_engine(cuda, arch: str, repeats: int | None = None, **scfg):
    """An ``Engine`` on the card over the smoke config's parameters
    (float32; ``repeats`` periods of its pattern where given); ``eos_id``
    -1, so every row generates every token."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_model
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_map

    cfg = smoke(get_config(arch))
    if repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=repeats)
    params = tree_map(lambda t: t.to(cuda), init_model(cfg, torch.Generator().manual_seed(0)))
    return Engine(cfg, params, ServeConfig(eos_id=-1, **scfg), device=cuda)


def eager_turn(eng, prompts) -> list[np.ndarray]:
    """What ``eng.generate`` serves, greedy, without a graph: the prefill,
    then ``decode_step`` called eagerly at host positions on fresh caches."""
    from repro_torch.models import decode_step, init_cache, prefill

    cfg, scfg = eng.cfg, eng.scfg
    toks, _ = eng._pad_batch(prompts)
    B, L = toks.shape
    batch = {"tokens": torch.as_tensor(toks, device=eng.device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), device=eng.device)
    out = [list(p) for p in prompts]
    dtype = torch.float32 if scfg.cache_dtype == "float32" else torch.bfloat16
    with torch.no_grad():
        logits, cache = prefill(cfg, eng._run, batch, init_cache(cfg, B, scfg.max_seq, dtype, eng.device))
        for step in range(scfg.max_new_tokens):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            for o, t in zip(out, tok.tolist()):
                o.append(t)
            logits, cache = decode_step(cfg, eng._run, cache, tok[:, None], L + step)
    return [np.asarray(o, np.int32) for o in out]


@pytest.mark.parametrize("arch", SERVED)
def test_cuda_graph_replay_serves_the_eager_tokens(cuda, arch):
    """Every family the engine serves goes through one capture: the first
    decode step runs eagerly, the second is captured, the rest replay; the
    tokens are the eager path's, token for token."""
    eng = served_engine(cuda, arch, max_seq=48, max_new_tokens=6)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, eng.cfg.vocab_size, size=n).astype(np.int32) for n in (7, 12, 9)]
    got = eng.generate(prompts)
    assert eng._graph is not None
    for g, w in zip(got, eager_turn(eng, prompts)):
        np.testing.assert_array_equal(g, w)


def test_cuda_engine_captures_once_a_shape_and_frees_the_old_graph(cuda, monkeypatch):
    """A second turn of the same shape replays the graph it has, on the
    same caches; a turn of another batch size drops both and captures
    anew.  Each turn serves the eager path's tokens."""
    import gc
    import weakref

    from repro_torch.serve import Engine

    eng = served_engine(cuda, "qwen3-8b", max_seq=48, max_new_tokens=5)
    captured = []
    capture = Engine._capture
    monkeypatch.setattr(Engine, "_capture", lambda self: captured.append(self._tok.shape[0]) or capture(self))
    rng = np.random.default_rng(6)
    turns = [[rng.integers(2, eng.cfg.vocab_size, size=n).astype(np.int32) for n in lens]
             for lens in ((9, 9, 9), (11, 4, 10), (8, 8))]
    got = [eng.generate(turns[0])]
    graph, cache = weakref.ref(eng._graph), eng._cache
    got.append(eng.generate(turns[1]))
    assert captured == [3] and eng._graph is graph() and eng._cache is cache
    got.append(eng.generate(turns[2]))
    gc.collect()
    assert captured == [3, 2] and graph() is None and eng._cache is not cache
    for prompts, g in zip(turns, got):
        for a, b in zip(g, eager_turn(eng, prompts)):
            np.testing.assert_array_equal(a, b)


def test_cuda_replayed_steps_count_one_decode_attention_a_layer(cuda):
    """A replayed step adds the wrapper calls its capture recorded, so
    ``LAUNCHES`` counts one decode attention a layer a step, whether the
    step ran eagerly, was captured and replayed, or only replayed."""
    eng = served_engine(cuda, "qwen3-8b", repeats=3, max_seq=16, max_new_tokens=5)
    attn = sum(1 for _ in range(eng.cfg.repeats) for kind in eng.cfg.pattern if "attn" in kind)
    prompts = [np.arange(2, 10, dtype=np.int32), np.arange(20, 28, dtype=np.int32)]
    kernels.reset_launches()
    eng.generate(prompts)  # eager, captured and replayed, then replays
    assert attn >= 1 and kernels.reset_launches()["decode_attention"] == 5 * attn
    eng.generate(prompts)  # replays only
    assert kernels.reset_launches()["decode_attention"] == 5 * attn


def jamba_engine(cuda, **scfg):
    """An ``Engine`` on the card with AI21-Jamba2-Mini's port options (no
    positions, the Δ/B/C norms, unrenormalised gates, the dropless
    dispatch) at jamba-v0.1-52b's smoke widths, in bfloat16 with a
    bfloat16 cache; ``eos_id`` -1."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.options import with_options
    from repro_torch.models import init_model
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_map

    cfg = with_options(smoke(get_config("jamba-v0.1-52b")), compute_dtype="bfloat16", mamba_chunk=5,
                       use_rope=False, positions="none", mamba_dbc_norm=True, moe_renormalize=False,
                       moe_dispatch="dropless")
    params = tree_map(lambda t: t.to(cuda), init_model(cfg, torch.Generator().manual_seed(0)))
    return Engine(cfg, params, ServeConfig(eos_id=-1, cache_dtype="bfloat16", **scfg), device=cuda)


def test_cuda_jamba_options_capture_and_replay_the_eager_steps(cuda):
    """The Jamba options' decode step (Mamba state, the dropless experts'
    device-side sort and grouped products, the attention layer) captures;
    its replays serve the eager path's tokens, and each replay adds the
    expert counters its capture took back."""
    from repro_torch.core import spans

    eng = jamba_engine(cuda, max_seq=48, max_new_tokens=6)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, eng.cfg.vocab_size, size=12).astype(np.int32) for _ in range(3)]
    s0 = spans.snapshot()
    got = eng.generate(prompts)
    d = {k: v - s0[k] for k, v in spans.snapshot().items()}
    assert eng._graph is not None and eng._counted == {"moe.routed_slots": 4 * 3 * 2, "moe.expert_rows": 4 * 3 * 2}
    # the prefill's 12 tokens a row, then 6 decode steps: eager, captured and replayed, 4 replays
    assert d["moe.routed_slots"] == d["moe.expert_rows"] == 4 * 3 * 2 * (12 + 6)
    for g, w in zip(got, eager_turn(eng, prompts)):
        np.testing.assert_array_equal(g, w)


def test_cuda_jamba_prefill_and_decode_step_make_no_host_sync(cuda):
    """Neither the prefill nor a decode step at a device position waits on
    the card or copies a value to the host (the served turn's only copies
    are its sampled ids)."""
    from repro_torch.models import decode_step, init_cache, prefill

    eng = jamba_engine(cuda)
    toks = torch.randint(0, eng.cfg.vocab_size, (3, 17), generator=torch.Generator().manual_seed(9)).to(cuda)
    cache = init_cache(eng.cfg, 3, 32, torch.bfloat16, cuda)
    pos = torch.full((), 16, dtype=torch.int32, device=cuda)
    with torch.no_grad():
        prefill(eng.cfg, eng._run, {"tokens": toks[:, :16]}, cache)  # loads every library first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prefill(eng.cfg, eng._run, {"tokens": toks[:, :16]}, cache)
            decode_step(eng.cfg, eng._run, cache, toks[:, 16:], pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def test_cuda_decode_attention_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import gqa_decode

    q = torch.zeros((2, 1, 2, 2, 32), device=cuda)
    k = torch.zeros((2, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError):  # a cache that is not contiguous
        gqa_decode.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, 3)
    with pytest.raises(ValueError):  # hd 48
        gqa_decode.decode_attention(torch.zeros((2, 1, 2, 2, 48), device=cuda), torch.zeros((2, 16, 2, 48), device=cuda),
                                    torch.zeros((2, 16, 2, 48), device=cuda), 3)
    with pytest.raises(ValueError):  # a position that is not one int32 on the card
        gqa_decode.decode_attention(q, k, k, torch.tensor([3], device=cuda))
    with pytest.raises(ValueError):  # a host position with nothing visible
        gqa_decode.decode_attention(q, k, k, 40, window=8)


def test_cuda_calibration_summaries_bit_equal_to_cpu(cuda):
    """Engine.calibrate on the card: each batch's |hidden| summary (the row
    sort) and their merge (the merge kernel) bit-equal to the plain
    versions on the same values; the clip is that merge's quantile."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.core.histogram import build_exact, merge_list, quantile
    from repro_torch.models import init_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = smoke(get_config("qwen3-8b"))
    eng = Engine(cfg, init_model(cfg, torch.Generator(device=cuda).manual_seed(0)), ServeConfig())
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)} for _ in range(3)]
    kernels.reset_launches()
    out = eng.calibrate(batches, q=0.999, T=256)
    launches = kernels.reset_launches()
    assert launches["tile_sort"] >= 3 and launches["merge_cut"] >= 1, launches
    gpu, cpu = [], []
    for b in batches:
        v = eng.calibration_values(b)
        assert v.device.type == "cuda" and v.shape == (2 * 64 * cfg.d_model,)
        gpu.append(build_exact(v, 256))
        cpu.append(build_exact(v.cpu(), 256))
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.boundaries.cpu(), c.boundaries) and torch.equal(g.sizes.cpu(), c.sizes)
    mg, mc = merge_list(gpu, 254), merge_list(cpu, 254)
    assert torch.equal(mg.boundaries.cpu(), mc.boundaries) and torch.equal(mg.sizes.cpu(), mc.sizes)
    assert out["clip"] == float(quantile(mc, np.float32(0.999))) > 0
    assert out["n_calibration_values"] == 3 * 2 * 64 * cfg.d_model


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_cuda_train_step_matches_cpu_at_smoke_width(cuda, arch):
    """One float32 train step (quantile clipping) on the card against the
    CPU run of the same parameters and batch: loss and grad norm within rel
    1e-5, the clip threshold within rel 1e-4 (a gradient value picked by
    rank), parameters within lr and at most 0.1 % of them off by more than
    1e-6 (AdamW's first step moves an entry by lr·g/(|g| + eps), which the
    gradients' last-bit gap flips where |g| is near eps)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import make_opt_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = smoke(get_config(arch))
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=16, clip_mode="quantile")
    cpu = init_model(cfg, torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32),
             "mask": np.ones((4, 64), np.float32)}
    step = make_train_step(cfg, opt)
    pc, _, mc = step(cpu, make_opt_state(cpu, opt), batch)
    kernels.reset_launches()
    pg, sg, mg = step(gpu, make_opt_state(gpu, opt), batch)
    launches = kernels.reset_launches()
    assert launches["tile_sort"] > 0 and launches["merge_cut"] > 0, launches
    assert mg["loss"].device.type == "cuda" and int(sg["step"]) == 1
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-5), ("clip_threshold", 1e-4)):
        assert abs(float(mg[k]) - float(mc[k])) <= tol * abs(float(mc[k])), (k, float(mg[k]), float(mc[k]))
    lr = float(mc["lr"])
    far = total = 0
    for a, b in zip(leaves(pg), leaves(pc)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= lr
        far, total = far + int((d > 1e-6).sum()), total + d.numel()
    assert far <= 1e-3 * total, (far, total)


def test_cuda_grad_quantile_bit_equal_on_a_real_gradient_tree(cuda):
    """The gradients of a bfloat16, fully rematerialized smollm-135m loss
    (the stacked tree of the train step, 4 layers) through the card's
    grad_quantile and tree_summaries: thresholds and every leaf's summary
    bit-equal to the plain versions on the same gradients."""
    import dataclasses

    from repro_torch.configs import get_config, smoke
    from repro_torch.core.telemetry import grad_quantile, tree_summaries
    from repro_torch.models import init_model
    from repro_torch.train import make_grad_fn
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(smoke(get_config("smollm-135m")), repeats=4, remat_policy="full",
                              compute_dtype="bfloat16")
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32),
             "mask": np.ones((4, 128), np.float32)}
    _, grads = make_grad_fn(cfg)(params, batch)
    assert all(g.device.type == "cuda" and g.dtype == torch.float32 for g in leaves(grads))
    host = tree_map(lambda g: g.cpu(), grads)
    for q, T in ((0.999, 512), (0.99, 1024)):
        kernels.reset_launches()
        thr = grad_quantile(grads, q, T)
        launches = kernels.reset_launches()
        assert launches["tile_sort"] == len(leaves(grads)) and launches["merge_cut"] == 1, launches
        assert torch.equal(thr.cpu(), grad_quantile(host, q, T))
        got, want = tree_summaries(grads, T), tree_summaries(host, T)
        assert list(got) == list(want)
        for k in got:
            assert torch.equal(got[k].boundaries.cpu(), want[k].boundaries), k
            assert torch.equal(got[k].sizes.cpu(), want[k].sizes), k


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_cuda_apply_moe_matches_cpu(cuda, arch):
    """apply_moe on the card against its CPU run, float32, the smoke
    config: the same routing (drop fraction equal), y and the aux losses
    within atol=rtol=1e-4; the decode fold too (B = 8, S = 1)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models.common import Init
    from repro_torch.models.moe import apply_moe, init_moe

    cfg = smoke(get_config(arch))
    p = init_moe(cfg, Init(torch.Generator().manual_seed(0), torch.device("cpu")))
    rng = np.random.default_rng(0)
    for shape in ((2, 40, cfg.d_model), (8, 1, cfg.d_model)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        with torch.no_grad():
            yc, ac = apply_moe(cfg, p, x)
            yg, ag = apply_moe(cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
        assert yg.device.type == "cuda"
        torch.testing.assert_close(yg.cpu(), yc, atol=1e-4, rtol=1e-4)
        for k in ("moe_load_balance", "moe_router_z"):
            torch.testing.assert_close(ag[k].cpu(), ac[k], atol=1e-4, rtol=1e-4)
        assert float(ag["moe_drop_fraction"]) == float(ac["moe_drop_fraction"])


@pytest.mark.parametrize("scan", ["float32", "bfloat16"])
def test_cuda_apply_mamba_matches_cpu(cuda, scan):
    """apply_mamba (two chunks and a tail) and decode_mamba_step on the
    card against their CPU runs, float32 compute: y and the state within
    atol=rtol=1e-4 with the float32 scan; with the bfloat16 scan, within
    2e-2 of their largest magnitudes (one bfloat16 rounding apart where
    the two devices' exp or product rounds differently)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke
    from repro_torch.models.common import Init
    from repro_torch.models.mamba import apply_mamba, decode_mamba_step, init_mamba, init_mamba_cache

    cfg = dataclasses.replace(smoke(get_config("jamba-v0.1-52b")), mamba_scan_dtype=scan)
    p = init_mamba(cfg, Init(torch.Generator().manual_seed(0), torch.device("cpu")))
    pg = {k: v.to(cuda) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 17, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        runs = {}
        for name, params, dev in (("cpu", p, "cpu"), ("gpu", pg, cuda)):
            y, h = apply_mamba(cfg, params, x.to(dev))
            cache = init_mamba_cache(cfg, 2, torch.float32, device=dev)
            cache["h"].copy_(h)
            step, new = decode_mamba_step(cfg, params, x[:, :1].to(dev), cache)
            runs[name] = [t.cpu() for t in (y, h, step, new["h"])]
    for a, b in zip(runs["gpu"], runs["cpu"]):
        if scan == "float32":
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())
