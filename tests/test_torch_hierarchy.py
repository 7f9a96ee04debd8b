"""Composed error bound of the port's hierarchical merge — the port's mirror
of ``tests/test_hierarchy.py``, each case also bit-equal to the reference's
``hierarchical_device_summary`` on the same seeded NumPy input.

Tolerance: bit-equal float32 boundaries and sizes (total mass < 2^24).
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as R
from repro_torch.core import (
    build_exact,
    hierarchical_device_summary,
    hierarchical_eps_bound,
    merge_list,
)


def both(x: np.ndarray, tile: int, T_tile: int, T_dev: int):
    """The port's device summary on the CPU, held bit-equal to the
    reference's; returns the port's as NumPy arrays."""
    got = hierarchical_device_summary(x, tile, T_tile, T_dev, device="cpu")
    want = R.hierarchical_device_summary(jnp.asarray(x), tile, T_tile, T_dev)
    b, s = got.boundaries.numpy(), got.sizes.numpy()
    assert b.tobytes() == np.asarray(want.boundaries).tobytes()
    assert s.tobytes() == np.asarray(want.sizes).tobytes()
    return b, s


@settings(deadline=None, max_examples=10)
@given(
    st.integers(0, 2**31 - 1),
    st.sampled_from([(512, 64, 128), (1024, 128, 256), (256, 32, 64)]),
)
def test_two_level_bound(seed, dims):
    tile, T_tile, T_dev = dims
    rng = np.random.default_rng(seed)
    n = tile * int(rng.integers(4, 12)) + int(rng.integers(0, tile))
    x = (rng.gumbel(size=n) * rng.uniform(0.5, 5)).astype(np.float32)
    _, sizes = both(x, tile, T_tile, T_dev)
    k_tiles = -(-n // tile)
    bound = 2 * n * (1 / T_tile + 1 / T_dev) + 2 * (k_tiles + 1)
    err = np.abs(sizes - n / T_dev).max()
    assert err <= bound + 1e-3, (err, bound)


def test_three_level_composition():
    """tile → device → global, each level a paper merge; composed bound,
    and the global merge bit-equal to the reference's ``merge_list``."""
    rng = np.random.default_rng(7)
    tile, T_tile, T_dev, T_glob = 512, 128, 256, 64
    n_dev, n_per = 8, 4096
    device_summaries, ref_summaries = [], []
    for _ in range(n_dev):
        x = rng.normal(size=n_per).astype(np.float32)
        device_summaries.append(hierarchical_device_summary(x, tile, T_tile, T_dev, device="cpu"))
        ref_summaries.append(R.hierarchical_device_summary(jnp.asarray(x), tile, T_tile, T_dev))
    final = merge_list(device_summaries, T_glob)
    want = R.merge_list(ref_summaries, T_glob)
    assert final.boundaries.numpy().tobytes() == np.asarray(want.boundaries).tobytes()
    assert final.sizes.numpy().tobytes() == np.asarray(want.sizes).tobytes()
    n = n_dev * n_per
    k_tiles = n_per // tile
    bound = hierarchical_eps_bound(n, (T_tile, T_dev, T_glob), (n_dev * k_tiles, n_dev))
    assert bound == R.hierarchical_eps_bound(n, (T_tile, T_dev, T_glob), (n_dev * k_tiles, n_dev))
    err = np.abs(final.sizes.numpy() - n / T_glob).max()
    assert err <= bound, (err, bound)
    # and it should be far tighter than the trivial bound n/T_glob
    assert err < n / T_glob


def test_hierarchy_accuracy_improves_with_T():
    rng = np.random.default_rng(11)
    x = rng.gumbel(size=65536).astype(np.float32)
    errs = []
    for T_tile in (32, 128, 512):
        _, sizes = both(x, 2048, T_tile, 64)
        errs.append(np.abs(sizes - x.size / 64).max())
    assert errs[0] >= errs[1] >= errs[2] - 1e-6


@pytest.mark.parametrize(
    "n, tile, T_tile, T_dev",
    [
        (100, 256, 32, 16),  # no whole tile: one exact histogram
        (256, 256, 32, 16),  # exactly one tile, no tail
        (1000, 256, 32, 64),  # a tail of 232 values
        (1030, 256, 32, 64),  # a tail of 6 values, fewer than T_tile
        (4096, 512, 512, 128),  # T_tile equal to the tile
    ],
)
def test_device_summary_edges_match_reference(n, tile, T_tile, T_dev):
    rng = np.random.default_rng(n)
    x = rng.integers(-30, 30, size=n).astype(np.float32)  # ties across tiles
    b, s = both(x, tile, T_tile, T_dev)
    assert float(s.sum()) == n
    if n < tile:
        exact = build_exact(x, T_dev, device="cpu")
        assert b.tobytes() == exact.boundaries.numpy().tobytes()


def test_int32_shard_keeps_its_dtype():
    rng = np.random.default_rng(5)
    x = rng.integers(-1000, 1000, size=3000).astype(np.int32)
    b, _ = both(x, 512, 64, 128)
    assert b.dtype == np.int32
