"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here skips without a card
(the fixture decides, at run time).  This file imports neither JAX nor
the reference package, so it runs on the GPU host as it is::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: bit-equal (``torch.equal``); the row sort compares NaN masks
and the non-NaN values, so ±0 compare equal.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ref


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


@pytest.mark.parametrize("beta", [1, 7, 64])
def test_cuda_merge_bit_equal(cuda, beta):
    rng = np.random.default_rng(beta)
    b = torch.sort(torch.from_numpy(rng.integers(0, 50, size=(16, 5, 65)).astype(np.float32)), -1).values
    s = torch.from_numpy(np.diff(ref.masked_cuts(rng.integers(64, 5000, size=80), 64), axis=-1)
                         .astype(np.float32).reshape(16, 5, 64))
    want = ref.merge_ref(b, s, beta)
    got = kernels.merge_batched(b.to(cuda), s.to(cuda), beta)
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)


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


def test_cuda_pre_histogram_and_empirical_sizes_match_cpu(cuda):
    from repro_torch.core import Histogram, build_exact, empirical_sizes, merge, pre_histogram

    rng = np.random.default_rng(5)
    v = rng.integers(0, 40, size=5000).astype(np.float32)  # heavy ties
    hs = [build_exact(part, 24) for part in np.split(v, 5)]
    h = Histogram(torch.stack([x.boundaries for x in hs]), torch.stack([x.sizes for x in hs]))
    hd = Histogram(h.boundaries.to(cuda), h.sizes.to(cuda))
    for a, b in zip(pre_histogram(hd), pre_histogram(h)):
        assert torch.equal(a.cpu(), b)
    m = merge(h, 9)
    got = empirical_sizes(torch.from_numpy(v).to(cuda), m.boundaries.to(cuda))
    assert torch.equal(got.cpu(), empirical_sizes(v, m.boundaries))
