"""Port parity: ``repro_torch.kernels`` public entry points against
``repro.kernels``.

The same seeded NumPy inputs go through the Pallas wrappers (interpret
mode, as ``tests/test_kernels.py`` runs them) and through the port on the
CPU (``device="cpu"``: the kernels' plain versions).  Tolerance: bit-equal
(``np.array_equal``), except where a test says what differs and why:

- ``cumulative_counts_pallas`` counts its ``+inf`` padding when
  ``b_T = +inf``; the port follows the reference's oracle there;
- above 2^24 total, the reference's float32 ``bucket_sizes`` rounds; the
  port's sizes are differences of integer counts.

Also: non-tensor input goes to the card by default (and raises without
one), and the import gate still holds with ``ops`` and ``tenant``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import (
    bucket_sizes_pallas,
    cumulative_counts_pallas,
    merge_histograms_pallas,
    summarize_pallas,
)
from repro.kernels import ref as RK
from repro.kernels.tile_sort import pad_to_tiles as ref_pad_to_tiles
from repro_torch import kernels as K
from repro_torch.kernels import ref as PK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(rng, n, dtype):
    if dtype == np.int32:
        return rng.integers(-100, 100, size=n).astype(dtype)
    return (rng.normal(size=n) * 10).astype(dtype)


# ------------------------------------------------------------ bucket count
@pytest.mark.parametrize("n", [100, 8192, 50_000])
@pytest.mark.parametrize("T", [4, 64, 257])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_cumulative_counts_match_pallas(n, T, dtype):
    rng = np.random.default_rng(n * 7 + T)
    x = _values(rng, n, dtype)
    b = np.sort(rng.normal(size=T + 1) * 10).astype(np.float32)
    want = np.asarray(cumulative_counts_pallas(jnp.asarray(x), jnp.asarray(b)))
    got = K.cumulative_counts(x, b, device="cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.bucket_sizes(x, b, device="cpu").numpy(),
        np.asarray(bucket_sizes_pallas(jnp.asarray(x), jnp.asarray(b))),
    )


@pytest.mark.parametrize("block_rows", [8, 64])
def test_cumulative_counts_match_every_pallas_block_shape(block_rows):
    rng = np.random.default_rng(block_rows)
    x = rng.normal(size=5000).astype(np.float32)
    b = np.sort(rng.normal(size=33)).astype(np.float32)
    want = cumulative_counts_pallas(jnp.asarray(x), jnp.asarray(b), block_rows=block_rows)
    assert np.array_equal(K.cumulative_counts(x, b, device="cpu").numpy(), np.asarray(want))


def test_bucket_sizes_of_an_exact_histogram_equal_its_sizes():
    x = np.random.default_rng(1).gumbel(size=20_000).astype(np.float32)
    h = R.build_exact(jnp.asarray(x), 64)
    want = np.asarray(bucket_sizes_pallas(jnp.asarray(x), h.boundaries))
    got = K.bucket_sizes(x, np.asarray(h.boundaries), device="cpu").numpy()
    assert np.array_equal(got, want) and np.array_equal(got, np.asarray(h.sizes))
    assert float(got.sum()) == 20_000


def test_inf_last_boundary_follows_the_oracle_not_the_padded_kernel():
    """``cumulative_counts_pallas`` pads the stream with +inf to whole
    (block_rows, 128) tiles and counts the padding as equal to b_T = +inf:
    8,188 pad values here.  Its oracle and ``empirical_sizes`` do not, and
    neither does the port."""
    x = np.array([1, 2, np.inf, np.nan], np.float32)
    b = np.array([0, 1.5, np.inf], np.float32)
    pallas = np.asarray(cumulative_counts_pallas(jnp.asarray(x), jnp.asarray(b)))
    oracle = np.asarray(RK.cumulative_counts_ref(jnp.asarray(x), jnp.asarray(b)))
    got = K.cumulative_counts(x, b, device="cpu").numpy()
    np.testing.assert_array_equal(oracle, [0, 1, 2, 1])
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(
        PK.cumulative_counts_ref(torch.from_numpy(x), torch.from_numpy(b)).numpy(), oracle
    )
    pad = 64 * 128 - x.size
    np.testing.assert_array_equal(pallas, [0, 1, 2, 1 + pad])
    np.testing.assert_array_equal(
        K.bucket_sizes(x, b, device="cpu").numpy(),
        np.asarray(R.empirical_sizes(jnp.asarray(x), jnp.asarray(b))),
    )


@pytest.mark.parametrize(
    "name,x,b",
    [
        ("nan/inf/±0 values", [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 2.0, np.nan], [-0.0, 0.0, 1.0, 2.0]),
        ("-inf first boundary", [-np.inf, -1.0, 0.0, 3.0], [-np.inf, 0.0, 3.0]),
        ("nan boundaries at the end", [0.0, 1.0, 2.0, np.nan, 5.0], [0.5, 1.5, np.nan, np.nan]),
        ("ties", [1.0, 1.0, 1.0, 2.0, 2.0, 3.0], [1.0, 1.0, 2.0, 2.0, 3.0]),
        ("empty stream", [], [0.0, 1.0]),
        ("all boundaries nan", [0.0, 1.0, np.inf, np.nan], [np.nan, np.nan, np.nan]),
    ],
)
def test_cumulative_counts_edge_cases_match_the_oracle(name, x, b):
    x, b = np.asarray(x, np.float32), np.asarray(b, np.float32)
    want = np.asarray(RK.cumulative_counts_ref(jnp.asarray(x), jnp.asarray(b)))
    assert np.array_equal(K.cumulative_counts(x, b, device="cpu").numpy(), want), name


@pytest.mark.parametrize("b", [[0.0, 2.0, 1.0], [0.0, np.nan, 1.0], [np.nan, 0.0]])
def test_unsorted_boundaries_are_rejected(b):
    with pytest.raises(ValueError):
        K.cumulative_counts(np.ones(4, np.float32), np.asarray(b, np.float32), device="cpu")
    with pytest.raises(ValueError):
        K.bucket_sizes(np.ones(4, np.float32), np.asarray(b, np.float32), device="cpu")


def test_int32_above_2_pow_24_cast_as_the_reference_casts():
    rng = np.random.default_rng(3)
    x = rng.integers(2**24, 2**31 - 1, size=20_000, dtype=np.int32)
    b = np.sort(rng.integers(2**24, 2**31 - 1, size=17)).astype(np.float32)
    want = np.asarray(cumulative_counts_pallas(jnp.asarray(x), jnp.asarray(b)))
    assert np.array_equal(K.cumulative_counts(x, b, device="cpu").numpy(), want)


def test_bucket_sizes_stay_exact_above_2_pow_24_total():
    """2^24 values in the first bucket and 5 in the second: the float32
    cumulative count 2^24 + 5 rounds to 2^24 + 4, so the reference's
    float32 difference gives the second bucket 4; the port, which takes
    the difference of its integer counts, gives 5."""
    x = np.concatenate([np.zeros(2**24, np.float32), np.full(5, 2.0, np.float32)])
    b = np.array([-1.0, 1.0, 3.0], np.float32)
    got = K.bucket_sizes(x, b, device="cpu").numpy()
    np.testing.assert_array_equal(got, [2**24, 5])
    cum = K.cumulative_counts(x, b, device="cpu").numpy()
    np.testing.assert_array_equal(cum, [0, 2**24, 2**24 + 4, 0])  # float32 contract
    reference_way = np.asarray(RK.bucket_sizes_from_cumulative(jnp.asarray(cum)))
    np.testing.assert_array_equal(reference_way, [2**24, 4])


# --------------------------------------------------------- tile Summarizer
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n", [2 * 512 + 117, 512])
def test_pad_to_tiles_matches_reference(dtype, n):
    x = _values(np.random.default_rng(n), n, dtype)
    want = np.asarray(ref_pad_to_tiles(jnp.asarray(x), 512))
    got = K.pad_to_tiles(torch.from_numpy(x), 512).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize(
    "n,tile_len,T_tile,T_out",
    [(2 * 512 + 117, 512, 32, 32), (128, 128, 16, 16), (517, 1024, 64, 64), (3 * 1024 + 517, 1024, 64, 128)],
)
@pytest.mark.parametrize("fused_merge", [True, False])
def test_summarize_tiles_matches_summarize_pallas(n, tile_len, T_tile, T_out, fused_merge):
    x = np.random.default_rng(n).gumbel(size=n).astype(np.float32)
    hr = summarize_pallas(
        jnp.asarray(x), tile_len=tile_len, T_tile=T_tile, T_out=T_out, fused_merge=fused_merge
    )
    hp = K.summarize_tiles(x, tile_len=tile_len, T_tile=T_tile, T_out=T_out, device="cpu")
    assert np.array_equal(np.asarray(hr.boundaries), hp.boundaries.numpy())
    assert np.array_equal(np.asarray(hr.sizes), hp.sizes.numpy())
    tiles = -(-n // tile_len)
    true = K.bucket_sizes(x, hp.boundaries).numpy()
    assert np.abs(true - hp.sizes.numpy()).max() <= 2 * n / T_tile + 2 * tiles


def test_summarize_tiles_int32_input_is_cast_to_float32():
    x = np.random.default_rng(4).integers(-50, 50, size=700).astype(np.int32)
    hr = summarize_pallas(jnp.asarray(x), tile_len=256, T_tile=16, T_out=16)
    hp = K.summarize_tiles(x, tile_len=256, T_tile=16, T_out=16, device="cpu")
    assert hp.boundaries.dtype == torch.float32
    assert np.array_equal(np.asarray(hr.boundaries), hp.boundaries.numpy())
    assert np.array_equal(np.asarray(hr.sizes), hp.sizes.numpy())
    with pytest.raises(ValueError):
        K.summarize_tiles(np.zeros(0, np.float32), device="cpu")


# ------------------------------------------------------------------ Merger
@pytest.mark.parametrize("seed,k,T,beta", [(0, 1, 4, 2), (2, 7, 15, 5), (4, 3, 41, 12), (7, 4, 20, 19)])
def test_merge_histograms_matches_pallas(seed, k, T, beta):
    rng = np.random.default_rng(seed)
    hs = [R.build_exact(jnp.asarray(rng.integers(0, 8, size=int(rng.integers(T, 400))).astype(np.float32)), T)
          for _ in range(k)]
    b = np.stack([np.asarray(h.boundaries) for h in hs])
    s = np.stack([np.asarray(h.sizes) for h in hs])
    want = merge_histograms_pallas(R.Histogram(jnp.asarray(b), jnp.asarray(s)), beta)
    got = K.merge_histograms(R.Histogram(b, s), beta, device="cpu")
    assert np.array_equal(np.asarray(want.boundaries), got.boundaries.numpy())
    assert np.array_equal(np.asarray(want.sizes), got.sizes.numpy())


# ------------------------------------------------------- device by default
def test_non_tensor_input_goes_to_the_card_by_default(monkeypatch):
    """Without a card every public entry point refuses host input unless
    asked for the CPU — no silent fallback; tensors stay where they lie."""
    from repro_torch.core import (
        HistogramStore,
        TenantRegistry,
        build_exact,
        empirical_sizes,
        merge,
        merge_stacks,
        range_count,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(5)
    v = rng.normal(size=300).astype(np.float32)
    b = np.sort(rng.normal(size=(2, 3, 9)), axis=-1).astype(np.float32)
    s = np.full((2, 3, 8), 2.0, np.float32)
    calls = [
        lambda **kw: build_exact(v, 8, **kw),
        lambda **kw: merge(R.Histogram(b[0], s[0]), 4, **kw),
        lambda **kw: merge_stacks(b, s, 4, **kw),
        lambda **kw: empirical_sizes(v, np.sort(v)[::30], **kw),
        lambda **kw: range_count(R.Histogram(b[0, 0], s[0, 0]), -1.0, 1.0, **kw),
        lambda **kw: K.bucket_sizes(v, np.sort(v)[::30], **kw),
        lambda **kw: K.cumulative_counts(v, np.sort(v)[::30], **kw),
        lambda **kw: K.summarize_tiles(v, tile_len=128, T_tile=8, T_out=8, **kw),
        lambda **kw: K.merge_histograms(R.Histogram(b[0], s[0]), 4, **kw),
        lambda **kw: TenantRegistry(num_buckets=8, **kw),
        lambda **kw: HistogramStore(num_buckets=8, **kw),
    ]
    for i, call in enumerate(calls):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        out = call(device="cpu")
        first = out[0] if isinstance(out, tuple) else out
        if isinstance(first, torch.Tensor):
            assert first.device.type == "cpu", i
    store = HistogramStore(num_buckets=8, device="cpu")
    store.ingest(0, v)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store.summaries[0].to_histogram()
    assert store.summaries[0].to_histogram("cpu").boundaries.device.type == "cpu"
    # a CPU tensor needs no keyword
    assert build_exact(torch.from_numpy(v), 8).boundaries.device.type == "cpu"
    assert K.bucket_sizes(torch.from_numpy(v), np.sort(v)[::30]).device.type == "cpu"
    assert np.array_equal(store.quantile_query(0, 0, [0.5]), store.quantile_query(0, 0, [0.5]))


def test_import_gate_holds_with_ops_and_tenant():
    code = (
        "import sys; import repro_torch, repro_torch.kernels.ops, repro_torch.core.tenant; "
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules, "
        "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
        "from repro_torch.kernels import _lib; assert _lib._LIBS == {}; "
        "assert _lib.KERNELS['bucket_count'] == 'bucket_count.cu'; "
        "assert set(_lib.LAUNCHES) == set(_lib.KERNELS)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert out.returncode == 0, out.stderr


def test_cpu_wrappers_launch_nothing():
    rng = np.random.default_rng(6)
    x = rng.normal(size=3000).astype(np.float32)
    K.reset_launches()
    K.bucket_sizes(x, np.sort(x)[::100], device="cpu")
    K.summarize_tiles(x, tile_len=512, T_tile=16, T_out=16, device="cpu")
    assert all(c == 0 for c in K.LAUNCHES.values())
