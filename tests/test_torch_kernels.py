"""The port's kernels: plain versions against the Pallas kernels, and the
wrappers' dispatch.

On the CPU each wrapper runs its plain version (``repro_torch.kernels.ref``)
and launches nothing.  The plain versions are held to the JAX package's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them) at
that file's own tolerances — and the kv sort to the exact stable order,
which is stricter than its payload-multiset check.  The CUDA kernels
themselves are held to the plain versions on the card by ``chip_smoke.py``
and by ``tests/test_torch_cuda.py``, which skips without a card.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Histogram, build_exact, merge
from repro.kernels import merge_pallas, sort_kv_pallas, sort_tiles_pallas
from repro_torch import kernels
from repro_torch.core import Histogram as TorchHistogram
from repro_torch.kernels import ref

RNG_SEED = 42


@pytest.mark.parametrize("tiles,tile_len", [(1, 128), (4, 1024)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sort_rows_ref_matches_pallas(tiles, tile_len, dtype):
    rng = np.random.default_rng(RNG_SEED)
    if dtype == np.int32:
        x = rng.integers(-1000, 1000, size=(tiles, tile_len)).astype(dtype)
    else:
        x = rng.normal(size=(tiles, tile_len)).astype(dtype)
    want = np.asarray(sort_tiles_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(ref.sort_rows_ref(torch.from_numpy(x)).numpy(), want)


def test_sort_rows_ref_duplicates_and_extremes():
    rng = np.random.default_rng(RNG_SEED)
    x = np.concatenate([
        np.full(100, 3.0), np.full(50, -7.0), rng.integers(0, 5, 874).astype(np.float32),
    ]).astype(np.float32)[None, :1024]
    want = np.asarray(sort_tiles_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(ref.sort_rows_ref(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("tile_len", [256, 512])
def test_sort_kv_ref_matches_pallas_exact_stable_order(tile_len):
    rng = np.random.default_rng(tile_len)
    keys = rng.integers(0, 7, size=(2, tile_len)).astype(np.float32)
    vals = np.arange(2 * tile_len, dtype=np.float32).reshape(2, tile_len)  # unique payload
    pk, pv = (np.asarray(a) for a in sort_kv_pallas(jnp.asarray(keys), jnp.asarray(vals)))
    tk, tv = ref.sort_kv_ref(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(tk.numpy(), pk)
    np.testing.assert_array_equal(tv.numpy(), pv)  # the same permutation
    order = np.argsort(keys, axis=-1, kind="stable")
    np.testing.assert_array_equal(tv.numpy(), np.take_along_axis(vals, order, -1))


@pytest.mark.parametrize("k,T,beta", [(1, 4, 2), (3, 16, 16), (7, 18, 5), (2, 8, 1)])
def test_merge_ref_matches_pallas(k, T, beta):
    rng = np.random.default_rng(RNG_SEED + k)
    hs = [
        build_exact(jnp.asarray(rng.normal(size=int(rng.integers(T, 400))).astype(np.float32)), T)
        for _ in range(k)
    ]
    b = np.stack([np.asarray(h.boundaries) for h in hs])
    s = np.stack([np.asarray(h.sizes) for h in hs])
    bo, so = merge_pallas(jnp.asarray(b), jnp.asarray(s), beta)
    rb, rs = ref.merge_ref(torch.from_numpy(b)[None], torch.from_numpy(s)[None], beta)
    np.testing.assert_allclose(rb[0].numpy(), np.asarray(bo), rtol=1e-6)
    np.testing.assert_allclose(rs[0].numpy(), np.asarray(so), atol=1e-2)


def test_merge_ref_all_tied_boundaries():
    b = np.full((2, 5), 3.0, np.float32)
    s = np.full((2, 4), 10.0, np.float32)
    bo, so = merge_pallas(jnp.asarray(b), jnp.asarray(s), 3)
    rb, rs = ref.merge_ref(torch.from_numpy(b)[None], torch.from_numpy(s)[None], 3)
    np.testing.assert_allclose(rb[0].numpy(), np.asarray(bo))
    np.testing.assert_allclose(rs[0].numpy(), np.asarray(so))
    assert float(rs.sum()) == 80.0


def test_merge_keeps_an_inf_max_that_merge_pallas_zeroes():
    # merge_cut_kernel maps non-finite boundaries to 0 before its one-hot
    # gathers (repro/kernels/merge_cut.py:63-73); the port gathers the bits
    b = np.array([[0, 1, 2, np.inf], [0.5, 1.5, 2.5, 3.5]], np.float32)
    s = np.ones((2, 3), np.float32)
    bo, _ = merge_pallas(jnp.asarray(b), jnp.asarray(s), 3)
    np.testing.assert_array_equal(np.asarray(bo), [0, 1, 2, 0])
    oracle = merge(Histogram(jnp.asarray(b), jnp.asarray(s)), 3)
    got = kernels.merge_histograms(TorchHistogram(torch.from_numpy(b), torch.from_numpy(s)), 3, device="cpu")
    np.testing.assert_array_equal(got.boundaries.numpy(), [0, 1, 2, np.inf])
    np.testing.assert_array_equal(got.boundaries.numpy(), np.asarray(oracle.boundaries))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(oracle.sizes))


def test_sort_rows_keeps_numbers_where_bitonic_spreads_nan():
    # _bitonic's jnp.minimum/maximum turn a tile holding NaN into all NaN
    rng = np.random.default_rng(RNG_SEED)
    x = rng.normal(size=(1, 256)).astype(np.float32)
    x[0, [3, 100]] = np.nan
    assert np.isnan(np.asarray(sort_tiles_pallas(jnp.asarray(x)))).all()
    got = kernels.sort_rows(torch.from_numpy(x)).numpy()
    assert np.isnan(got[0, 254:]).all() and not np.isnan(got[0, :254]).any()
    np.testing.assert_array_equal(got[0, :254], np.sort(x[0][~np.isnan(x[0])]))
    assert torch.equal(ref.sort_rows_ref(torch.from_numpy(x))[:, :254], torch.from_numpy(got[:, :254]))


def test_sort_kv_sorts_nan_keys_that_bitonic_kv_leaves_unsorted():
    # _bitonic_kv swaps both lanes when a key is NaN (neither lex_le nor lex_ge)
    rng = np.random.default_rng(RNG_SEED)
    keys = rng.normal(size=(1, 256)).astype(np.float32)
    keys[0, [3, 100]] = np.nan
    vals = np.arange(256, dtype=np.float32)[None]
    pk = np.asarray(sort_kv_pallas(jnp.asarray(keys), jnp.asarray(vals))[0])[0]
    numbers = pk[~np.isnan(pk)]
    assert not np.isnan(pk[254:]).all() and np.any(np.diff(numbers) < 0)
    tk, tv = kernels.sort_kv(torch.from_numpy(keys), torch.from_numpy(vals))
    assert np.isnan(tk[0, 254:].numpy()).all() and not np.isnan(tk[0, :254].numpy()).any()
    np.testing.assert_array_equal(tv[0].numpy(), np.argsort(keys[0], kind="stable").astype(np.float32))


def test_summarize_rows_ref_masked_cuts():
    x = torch.tensor([[5.0, 1.0, 3.0, float("inf")], [2.0, 2.0, 9.0, 0.0]])
    got = ref.summarize_rows_ref(x, [3, 4], 2)
    # row 0: sorted [1,3,5], cuts [0,1,3]→clamped 2; row 1: [0,2,2,9], cuts [0,2,4]→3
    assert torch.equal(got, torch.tensor([[1.0, 3.0, 5.0], [0.0, 2.0, 9.0]]))
    np.testing.assert_array_equal(ref.masked_cuts([7], 3), [[0, 2, 4, 7]])


def test_cpu_tensors_reach_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    rng = np.random.default_rng(RNG_SEED)
    x = torch.from_numpy(rng.normal(size=(3, 100)).astype(np.float32))
    assert torch.equal(kernels.sort_rows(x), ref.sort_rows_ref(x))
    assert torch.equal(kernels.summarize_rows(x, [100, 50, 1], 8), ref.summarize_rows_ref(x, [100, 50, 1], 8))
    keys = torch.from_numpy(rng.integers(0, 4, size=(2, 64)).astype(np.float32))
    vals = torch.arange(128, dtype=torch.float32).reshape(2, 64)
    for a, b in zip(kernels.sort_kv(keys, vals), ref.sort_kv_ref(keys, vals)):
        assert torch.equal(a, b)
    b = torch.sort(torch.from_numpy(rng.normal(size=(4, 3, 9)).astype(np.float32)), dim=-1).values
    s = torch.ones((4, 3, 8))
    for a, w in zip(kernels.merge_batched(b, s, 5), ref.merge_ref(b, s, 5)):
        assert torch.equal(a, w)
    v = torch.from_numpy(rng.normal(size=500).astype(np.float32))
    edges = torch.sort(v[::50]).values
    assert torch.equal(kernels.cumulative_counts(v, edges), ref.cumulative_counts_ref(v, edges))
    assert kernels.LAUNCHES == {"tile_sort": 0, "sort_kv": 0, "merge_cut": 0, "bucket_count": 0,
                                "decode_attention": 0}


def test_wrappers_reject_bad_arguments():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        kernels.summarize_rows(x, [9, 1], 4)  # n > width
    with pytest.raises(ValueError):
        kernels.summarize_rows(x, [1], 4)  # one length per row
    with pytest.raises(ValueError):
        kernels.merge_batched(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 5)), 2)
    with pytest.raises(ValueError):
        kernels.merge_batched(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 4)), 0)
    with pytest.raises(ValueError):  # no such regime
        kernels.merge_batched(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 4)), 2, regime="onesweep")
    with pytest.raises(ValueError):  # 5 × 3277 boundaries do not fit one block
        kernels.merge_batched(torch.zeros((1, 5, 3277)), torch.zeros((1, 5, 3276)), 2, regime="resident")
    with pytest.raises(ValueError):
        kernels.sort_kv(torch.zeros((2, 4)), torch.zeros((2, 5)))
    with pytest.raises(ValueError):  # CUDA-only stage, given a CPU tensor
        kernels.argsort_pairs(torch.zeros((2, 4)), 4)


def test_every_counted_kernel_has_its_source():
    from repro_torch.kernels import _lib

    assert set(_lib.KERNELS) == set(kernels.LAUNCHES)
    for src in _lib.KERNELS.values():
        assert os.path.exists(os.path.join(_lib._CSRC, src)), src
    assert os.path.exists(os.path.join(_lib._CSRC, "radix_sort.cuh"))
    assert _lib.build_dir().startswith(os.path.join(_lib._REPO, "build", "repro_torch_kernels"))
