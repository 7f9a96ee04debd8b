"""The design of the port's radix sort (``csrc/radix_sort.cuh``), on the CPU.

The CUDA kernels run only on the card.  What they compute is mirrored
here in numpy, index for index, and held to the plain versions:

- the order-preserving codec plus four stable 8-bit digit passes, least
  significant first, gives exactly ``torch.sort(stable=True)``'s order;
- the in-block ranking (per-warp digit counters, a digit's lanes found
  through a bitmask word, warp-major scan) puts every key at its stable
  position, for every block shape the kernels instantiate;
- onesweep's tiles, per-row digit offsets and decoupled look-back compose
  to the same positions;
- the wrapper's choice of regime and its scratch sizes agree with the
  kernels' geometry, at and around the resident limit.

Tolerance: exact (integer orders and bit patterns).
"""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib, ref, tile_sort

F32_SPECIAL = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3.4e38, -3.4e38, 1.0, -1.0],
    np.float32,
)


def enc_np(x: np.ndarray) -> np.ndarray:
    """numpy mirror of hk::enc_key: uint32 keys."""
    u = x.view(np.uint32).astype(np.uint64)
    if x.dtype == np.int32:
        return (u ^ 0x80000000).astype(np.uint32)
    k = np.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    k = np.where(x == 0, 0x80000000, k)
    k = np.where(np.isnan(x), 0xFFFFFFFF, k)
    return k.astype(np.uint32)


def dec_np(k: np.ndarray, dtype) -> np.ndarray:
    """numpy mirror of hk::dec_key."""
    k = k.astype(np.uint32)
    if dtype == np.int32:
        return (k ^ np.uint32(0x80000000)).view(np.int32)
    u = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    return u.view(np.float32)


def lsd_order(keys: np.ndarray) -> np.ndarray:
    """Four stable passes of 8-bit digits over uint32 keys: the order."""
    order = np.arange(keys.shape[0])
    for p in range(4):
        d = (keys[order] >> np.uint32(8 * p)) & 0xFF
        order = order[np.argsort(d, kind="stable")]
    return order


def nan_with_payload(rng, n: int) -> np.ndarray:
    bits = (0x7FC00000 | rng.integers(1, 1 << 22, size=n)).astype(np.uint32)
    bits[::2] |= np.uint32(0x80000000)  # negative NaNs too
    return bits.view(np.float32)


def key_cases():
    rng = np.random.default_rng(13)
    x = rng.normal(size=3000).astype(np.float32)
    at = rng.integers(0, x.size, 600)
    x[at] = rng.choice(F32_SPECIAL, at.size)
    yield "f32 specials", x
    y = np.round(rng.normal(size=2000) * 3).astype(np.float32)
    y[rng.integers(0, y.size, 200)] = nan_with_payload(rng, 200)
    yield "f32 ties and NaN payloads", y
    z = rng.normal(size=1000).astype(np.float32)
    z[100:110] = np.nan
    z[110:] = rng.integers(-3, 3, size=890).astype(np.float32)  # payloads past a NaN
    yield "values after a NaN", z
    i = rng.integers(-50, 50, size=4000).astype(np.int32)
    i[:7] = [-(2**31), 2**31 - 1, 0, -1, 1, 2**31 - 1, -(2**31)]
    yield "i32 ties and extremes", i
    yield "i32 full range", rng.integers(-(2**31), 2**31 - 1, size=5000, dtype=np.int64).astype(np.int32)
    yield "all equal", np.full(700, 2.5, np.float32)
    yield "one key", np.array([-0.0], np.float32)


@pytest.mark.parametrize("name,x", list(key_cases()), ids=[c[0] for c in key_cases()])
def test_codec_and_four_digit_passes_give_torch_stable_order(name, x):
    keys = enc_np(x)
    assert np.array_equal(keys.astype(np.int64), ref.encode_keys(torch.from_numpy(x)).numpy())
    order = lsd_order(keys)
    want = torch.sort(torch.from_numpy(x), stable=True).indices.numpy()
    assert np.array_equal(order, want), name
    # the decoded keys are the sorted values (NaN canonical, -0 → +0)
    got = dec_np(keys[order], x.dtype)
    sv = np.sort(x, kind="stable")
    if x.dtype == np.float32:
        assert np.array_equal(np.isnan(got), np.isnan(sv))
        assert np.array_equal(got[~np.isnan(got)], sv[~np.isnan(sv)])
        assert not np.signbit(got[got == 0]).any()
    else:
        assert np.array_equal(got, sv)


def test_codec_orders_like_the_values():
    k = enc_np(F32_SPECIAL)
    v = np.where(np.isnan(F32_SPECIAL), np.inf, F32_SPECIAL).astype(np.float64)
    for a in range(F32_SPECIAL.size):
        for b in range(F32_SPECIAL.size):
            na, nb = np.isnan(F32_SPECIAL[a]), np.isnan(F32_SPECIAL[b])
            if na or nb:  # NaN after everything, equal to itself
                assert (k[a] < k[b]) == (nb and not na)
            else:
                assert (k[a] < k[b]) == (v[a] < v[b]) and (k[a] == k[b]) == (v[a] == v[b])


def block_rank_positions(keys: np.ndarray, shift: int, warps: int, items: int) -> np.ndarray:
    """Mirror of rank_digits + scan_digits + place_local: the block-local
    position of each of the ``len(keys)`` valid keys of one block.  Key at
    tile position w·32·items + c·32 + lane is item c of that lane."""
    nvalid = keys.shape[0]
    S = 32 * items
    d = ((keys >> np.uint32(shift)) & 0xFF).astype(np.int64)
    wc = np.zeros((warps, 256), np.int64)
    rank = np.full(nvalid, -1, np.int64)
    for w in range(warps):  # rank in the warp: the counter + lanes of the digit below
        for c in range(items):
            first = w * S + c * 32
            if first >= nvalid:
                break
            lanes = np.arange(first, min(first + 32, nvalid))
            for i, at in enumerate(lanes):
                rank[at] = wc[w, d[at]] + np.count_nonzero(d[lanes[:i]] == d[at])
            digits, counts = np.unique(d[lanes], return_counts=True)
            wc[w, digits] += counts  # the leader's atomic add
    assert rank.max() < 1 << 16  # ranks are kept in 16 bits
    assert warps % 8 == 0
    groups = wc.reshape(warps // 8, 8, 256)  # eight warps a group
    in_group = (np.cumsum(groups, axis=1) - groups).reshape(warps, 256)
    gsum = groups.sum(axis=1)
    group_excl = np.cumsum(gsum, axis=0) - gsum
    total = gsum.sum(axis=0)
    start = np.cumsum(total) - total
    warp_of = np.arange(nvalid) // S
    return start[d] + group_excl[warp_of // 8, d] + in_group[warp_of, d] + rank


def header() -> str:
    with open(os.path.join(_lib._CSRC, "radix_sort.cuh")) as f:
        return f.read()


def resident_shapes() -> list[tuple[int, int, int]]:
    """(capacity, warps, items) of every case of launch_resident."""
    return [
        (int(c), int(w), int(i))
        for c, w, i in re.findall(r"case (\d+):\s*(?:if constexpr \(!KV\) )?return run_resident<(\d+), (\d+)", header())
    ]


@pytest.mark.parametrize("cap,warps,items", resident_shapes())
def test_block_ranking_is_a_stable_digit_sort(cap, warps, items):
    assert cap == warps * 32 * items
    rng = np.random.default_rng(cap)
    for nvalid in sorted({1, 31, 33, cap // 2 + 5, cap - 1, cap}):
        skew = rng.integers(0, 3, size=nvalid).astype(np.uint32) << np.uint32(8)  # two digits crowd
        keys = np.where(rng.random(nvalid) < 0.5, skew, rng.integers(0, 1 << 32, size=nvalid, dtype=np.uint64).astype(np.uint32))
        for shift in (0, 8):
            pos = block_rank_positions(keys, shift, warps, items)
            out = np.empty_like(keys)
            out[pos] = keys
            d = (keys >> np.uint32(shift)) & 0xFF
            assert np.array_equal(out, keys[np.argsort(d, kind="stable")]), (nvalid, shift)


def onesweep_positions(row: np.ndarray, shift: int, tile: int) -> np.ndarray:
    """Mirror of histogram_kernel + digit_scan_kernel + one onesweep pass:
    row offset of digit d + count of d in the row's earlier tiles (the
    look-back's exclusive sum) + the key's rank among d in its tile."""
    d = ((row >> np.uint32(shift)) & 0xFF).astype(np.int64)
    hist = np.bincount(d, minlength=256)
    offs = np.cumsum(hist) - hist
    tiles = -(-row.shape[0] // tile)
    counts = np.stack([np.bincount(d[t * tile : (t + 1) * tile], minlength=256) for t in range(tiles)])
    excl = np.cumsum(counts, axis=0) - counts
    pos = np.empty(row.shape[0], np.int64)
    for t in range(tiles):
        seg = d[t * tile : (t + 1) * tile]
        local = np.argsort(seg, kind="stable")  # the block ranking (checked above)
        start = np.cumsum(counts[t]) - counts[t]
        j = np.empty(seg.shape[0], np.int64)
        j[local] = np.arange(seg.shape[0])
        pos[t * tile + np.arange(seg.shape[0])] = offs[seg] + excl[t, seg] + j - start[seg]
    return pos


@pytest.mark.parametrize("width", [1, 100, 4095, 4097, 8191, 8192, 8193, 3 * 8192 + 17])
def test_onesweep_tiles_compose_to_the_stable_order(width):
    tile = tile_sort.LONG_TILE
    rng = np.random.default_rng(width)
    x = np.round(rng.normal(size=width) * 20).astype(np.float32)
    keys = enc_np(x)
    idx = np.arange(width)
    for p in range(4):
        pos = onesweep_positions(keys, 8 * p, tile)
        assert np.array_equal(np.sort(pos), np.arange(width))
        nk, ni = np.empty_like(keys), np.empty_like(idx)
        nk[pos], ni[pos] = keys, idx
        keys, idx = nk, ni
    assert np.array_equal(idx, torch.sort(torch.from_numpy(x), stable=True).indices.numpy())


def test_wrapper_geometry_matches_the_kernels():
    h = header()
    warps = int(re.search(r"kLongWarps = (\d+);", h).group(1))
    items = int(re.search(r"kLongItems = (\d+);", h).group(1))
    assert tile_sort.LONG_TILE == warps * 32 * items
    shapes = resident_shapes()
    assert tuple(c for c, _, _ in shapes) == tile_sort.RESIDENT_CAPS
    assert tile_sort.ROW_RESIDENT_LIMIT == tile_sort.RESIDENT_CAPS[-1]
    # the one capacity the kv sort's instances leave out
    assert "if constexpr (!KV) return run_resident<32, 32" in h
    assert tile_sort.KV_RESIDENT_LIMIT == tile_sort.RESIDENT_CAPS[-2]
    # onesweep scratch: rows × 1024 counts, 4 counters, 4 passes of tiles × 256
    assert "uint32_t* counter = scratch + (size_t)a.rows * 1024;" in h
    assert "uint32_t* status = counter + 4;" in h
    assert "const size_t per_pass = (size_t)a.rows * tpr * 256;" in h
    assert "status + p * per_pass" in h and "for (int p = 0; p < 4; ++p)" in h
    for i, mode in enumerate(("kKeys", "kValues", "kPairs", "kGather")):
        assert re.search(rf"constexpr int {mode} = {i};", h)
    assert (tile_sort._KEYS, tile_sort._VALUES, tile_sort._PAIRS, tile_sort._GATHER) == (0, 1, 2, 3)
    # shared memory of the largest resident blocks fits the card's 227 KB
    for cap, w, _ in shapes:
        kv = cap <= tile_sort.KV_RESIDENT_LIMIT
        words = (2 if kv else 1) * cap + w * 256 + 256 + 256 + 8 + w // 8 * 256 + w * 256
        assert 4 * words <= 232_448, cap


@pytest.mark.parametrize("kv", [False, True])
def test_regime_choice_at_and_around_the_resident_limit(kv):
    limit = tile_sort.KV_RESIDENT_LIMIT if kv else tile_sort.ROW_RESIDENT_LIMIT
    assert limit in tile_sort.RESIDENT_CAPS
    for width in (limit - 1, limit):
        assert tile_sort.plan(width, kv) == limit
        assert tile_sort.plan(width, kv, "resident") == limit
    assert tile_sort.plan(limit + 1, kv) == 0
    assert tile_sort.plan(1 << 20, kv) == 0
    for width in (1, 255, 256, 257, 511, 513, 4095, 4096, 4097):
        assert tile_sort.plan(width, kv) == min(c for c in tile_sort.RESIDENT_CAPS if c >= width)
    with pytest.raises(ValueError):
        tile_sort.plan(limit + 1, kv, "resident")
    assert tile_sort.plan(5, kv, "onesweep") == 0
    assert tile_sort.plan(limit + 1, kv, "onesweep") == 0
    with pytest.raises(ValueError):
        tile_sort.plan(5, kv, "fast")


@pytest.mark.parametrize("rows,width", [(1, 1), (3, 4096), (3, 8191), (3, 8192), (3, 8193), (256, 1 << 20), (1000, 65536)])
def test_onesweep_scratch_words(rows, width):
    tiles = rows * -(-width // tile_sort.LONG_TILE)
    words = tile_sort.onesweep_scratch_words(rows, width)
    assert words == rows * 4 * 256 + 4 + 4 * tiles * 256
    assert words < 2**31  # one int32 tensor


def test_argsort_pairs_ref_bits():
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(size=(3, 37)) * 2).astype(np.float32)
    x[0, :4] = [-0.0, np.nan, 0.0, -np.inf]
    got = ref.argsort_pairs_ref(torch.from_numpy(x), 64).numpy().view(np.uint64)
    for r in range(3):
        order = lsd_order(enc_np(x[r]))
        want = (enc_np(x[r])[order].astype(np.uint64) << np.uint64(32)) | order.astype(np.uint64)
        assert np.array_equal(got[r, :37], want)
        pads = (np.uint64(0xFFFFFFFF) << np.uint64(32)) | np.arange(37, 64, dtype=np.uint64)
        assert np.array_equal(got[r, 37:], pads)
