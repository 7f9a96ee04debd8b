"""The design of the port's bucket count (``csrc/bucket_count.cu``), on the CPU.

The CUDA kernel runs only on the card.  What it computes is mirrored here
in numpy, index for index, and held to the plain versions:

- the BFS (Eytzinger) table built from all T+1 boundaries (+inf where a
  boundary is NaN and past T+1), the count m of its numbers, and the
  d-step descent ``i = 2i + !(e[i] > v)`` give exactly
  ``torch.searchsorted(right=True)`` over the sorted prefix for every
  prefix length m = 0 … 300 and 2,047 … 2,049, with and without NaN
  boundaries after it, with ties, ±0 and ±inf, and p >= m for NaN;
- the fixed-step search of the global-memory regime does too;
- slots, per-block histograms in passes of a chunk of slots, and the
  blocks' cumulative counts added into a zeroed output give
  ``ref.counts_ref``;
- the head / float4 rounds / tail split visits every value once, at every
  16-byte offset, for the blocks and round lengths :func:`grid` picks;
- :func:`grid` keeps its rules, and the wrapper's geometry (and the
  largest T+1 that stays in shared memory) agrees with the kernel's
  constants.

Tolerance: exact (integer counts and positions).
"""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import bucket_count, ref

CU = os.path.join(os.path.dirname(bucket_count.__file__), "csrc", "bucket_count.cu")
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf], np.float32)


def depth(T1: int) -> int:
    """d = ceil(log2(T1 + 1)), as the kernel computes it."""
    return int(T1).bit_length()


def bfs_table(b: np.ndarray) -> tuple[np.ndarray, int]:
    """Mirror of the kernel's table build over all T+1 boundaries: e[0]
    unused, node i at level k = floor(log2 i) holds sorted position
    (2(i - 2^k) + 1)·2^(d-1-k) - 1, +inf where that is NaN or past T+1;
    and m, the numbers among the boundaries, which the block counts as it
    builds."""
    T1 = b.shape[0]
    d = depth(T1)
    e = np.full(1 << d, np.inf, np.float32)
    m = 0
    for i in range(1, 1 << d):
        k = i.bit_length() - 1
        pos = ((2 * (i - (1 << k)) + 1) << (d - 1 - k)) - 1
        if pos < T1 and not np.isnan(b[pos]):
            e[i] = b[pos]
            m += 1
    return e, m


def bfs_search(e: np.ndarray, d: int, v: np.ndarray) -> np.ndarray:
    """Mirror of ``search_bfs``: exactly d steps of i = 2i + !(e[i] > v)."""
    i = np.ones(v.shape, np.int64)
    for _ in range(d):
        i = 2 * i + ~(e[i] > v)
    return i - (1 << d)


def sorted_search(b: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Mirror of ``search_sorted``: the steps depend on m alone."""
    m = b.shape[0]
    lo = np.zeros(v.shape, np.int64)
    if m == 0:
        return lo
    length = m
    while length > 1:
        half = length >> 1
        lo += np.where(b[lo + half] > v, 0, half)
        length -= half
    return lo + ~(b[lo] > v)


def boundaries(rng, m: int, pad: int) -> np.ndarray:
    """m sorted boundaries with ties and ±0 (and ±inf at the ends when
    there is room), then ``pad`` NaNs."""
    b = np.round(rng.normal(size=m) * 3).astype(np.float32)
    if m >= 4:
        b[:2] = [-0.0, 0.0]
        b[2] = -np.inf
    if m >= 6:
        b[3] = np.inf
    return np.concatenate([np.sort(b), np.full(pad, np.nan, np.float32)]).astype(np.float32)


def values(rng, n: int) -> np.ndarray:
    v = np.round(rng.normal(size=n) * 3.5).astype(np.float32)
    at = rng.integers(0, n, n // 8)
    v[at] = rng.choice(np.concatenate([SPECIAL, [np.nan]]).astype(np.float32), at.size)
    return v


M_GROUPS = [list(range(lo, min(lo + 25, 301))) for lo in range(0, 301, 25)] + [[2047, 2048, 2049]]


@pytest.mark.parametrize("ms", M_GROUPS, ids=lambda ms: f"m{ms[0]}-{ms[-1]}")
def test_bfs_descent_is_searchsorted(ms):
    rng = np.random.default_rng(ms[0])
    for m in ms:
        for pad in (0, 3) if m >= 2 else (3,):  # the kernel takes T+1 >= 2
            b = boundaries(rng, m, pad)
            prefix = b[: ref.count_prefix(b)]
            assert prefix.shape[0] == m
            v = values(rng, 4000)
            v = np.concatenate([v, prefix, np.nextafter(prefix, np.float32(np.inf))])
            e, counted = bfs_table(b)
            d = depth(b.shape[0])
            assert counted == m
            assert e.shape[0] == 1 << d and (1 << (d - 1)) <= b.shape[0] < (1 << d)
            assert np.array_equal(np.sort(e[1:])[:m], prefix)  # each boundary once, then +inf
            got = bfs_search(e, d, v)
            want = torch.searchsorted(torch.from_numpy(prefix), torch.from_numpy(v), right=True).numpy()
            num, inf = ~np.isnan(v), v == np.inf
            assert np.array_equal(got[num & ~inf], want[num & ~inf]), (m, pad)
            assert np.all(got[num & ~inf] <= m)  # +inf nodes move only v = +inf right
            assert np.all(got[~num | inf] >= m) and np.all(want[inf] == m)  # NaN and +inf: p >= m
            for p, most in ((got, (1 << d) - 1), (sorted_search(prefix, v), m)):
                assert np.all(p >= 0) and np.all(p <= most)
                assert np.array_equal(np.minimum(p, m)[num], want[num]), (m, pad)


def kernel_counts(x: np.ndarray, b: np.ndarray, blocks: int, chunk: int | None) -> np.ndarray:
    """Mirror of the kernel from search to output: slots (p < top, or
    #(v == b_T) in slot top, NaN and the rest nowhere; top = T+1 with the
    table in shared memory, m in global memory); then each block, in passes of
    ``chunk`` slots (one pass of T + 2 with the table in shared memory),
    counts its values whose slot lies in the pass and adds its cumulative
    counts, carried over the passes before, into the zeroed output."""
    T1 = b.shape[0]
    e, m = bfs_table(b)
    last = b[T1 - 1]  # NaN, which nothing equals, when the boundaries end in NaN
    p = bfs_search(e, depth(T1), x)
    top = T1 if chunk is None else m  # the slot of #(v == b_T): T1 in shared memory, m in global
    slot = np.where(p < top, p, np.where(x == last, top, -1))
    stride = T1 + 1 if chunk is None else chunk
    out = np.zeros(T1 + 1, np.int64)
    for part in np.array_split(slot, blocks):
        carry = 0
        for lo in range(0, top + 1, stride):
            hi = lo + stride
            h = np.bincount(part[(part >= lo) & (part < hi)] - lo, minlength=stride)
            S = max(min(hi, m) - lo, 0)
            out[lo : lo + S] += carry + np.cumsum(h[:S])
            if lo <= top < hi:
                out[T1] += h[top - lo]
            carry += int(h[:S].sum())
    return out


@pytest.mark.parametrize("chunk", [None, 1, 7, 64])
@pytest.mark.parametrize("T1,pad", [(2, 0), (2, 2), (33, 0), (33, 5), (255, 0), (256, 0), (257, 0), (2049, 0), (40, 40)])
def test_kernel_mirror_counts_like_the_plain_version(T1, pad, chunk):
    rng = np.random.default_rng(T1 + pad)
    b = boundaries(rng, T1 - pad, pad)
    streams = [values(rng, 5000), np.full(999, b[T1 - pad - 1] if T1 > pad else 1.0, np.float32)]
    if pad == 0:
        b = b.copy()
        b[-1] = np.inf  # +inf counts in the last slot
        streams.append(np.concatenate([values(rng, 300), [np.inf] * 7]).astype(np.float32))
    for x in streams:
        want = ref.counts_ref(torch.from_numpy(x), torch.from_numpy(b)).numpy()
        for blocks in (1, 3):
            assert np.array_equal(kernel_counts(x, b, blocks, chunk), want), (blocks, chunk)


def visits(n: int, offset: int, blocks: int, per: int) -> np.ndarray:
    """How often the kernel reads each of n values that start ``offset``
    floats past a 16-byte boundary: block 0's scalar head and tail, and
    float4 base + k·THREADS + thread (k < 4, inside the round) of each
    round of ``per`` float4s of a block, the rounds of block g at float4
    (g + r·blocks)·per."""
    head = min((4 - offset) % 4, n)
    q = (n - head) // 4
    seen = np.zeros(n, np.int64)
    seen[:head] += 1
    o = (np.arange(4)[:, None] * bucket_count.THREADS + np.arange(bucket_count.THREADS)).ravel()
    o = o[o < per]
    for g in range(blocks):
        for base in range(g * per, q, blocks * per):
            i = base + o[base + o < q]
            for c in range(4):
                np.add.at(seen, head + 4 * i + c, 1)
    seen[head + 4 * q :] += 1
    return seen


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_head_rounds_and_tail_read_each_value_once(offset):
    for n in (0, 1, 2, 3, 4, 5, 17, 8191, 8192, 8197, 3 * 8192 + 7, 67_584, 743_424):
        grids = {(1, bucket_count.ROUND), (3, bucket_count.ROUND), (3, 32), (5, 544)}
        grids |= {bucket_count.grid(n, T1, sms) for T1 in (65, 2049) for sms in (1, 132)}
        for blocks, per in grids:
            assert np.all(visits(n, offset, blocks, per) == 1), (n, offset, blocks, per)


def test_short_rounds_idle_whole_warps():
    """Every round length :func:`grid` can pick is whole warps of float4s, so
    the loads of a warp that lie inside a round are its first ``groups``
    (the kernel's count), the same for every lane: a warp searches only
    those, and never diverges on it."""
    T = bucket_count.THREADS
    lanes = np.arange(32)
    for per in range(32, bucket_count.ROUND + 1, 32):
        for warp in range(T // 32):
            groups = sum(k * T + warp * 32 < per for k in range(4))
            inside = (np.arange(4)[:, None] * T + warp * 32 + lanes) < per
            assert np.array_equal(inside, np.arange(4)[:, None] < groups + 0 * lanes), (per, warp)


def test_grid_rules():
    full_round = bucket_count.ROUND
    for sms in (1, 132):
        for T1 in (2, 65, 255, 2049, 20_001, 40_001):
            for n in (0, 1, 5000, 67_584, 743_424, 1 << 20, 3 << 20, 383_778_816, 1 << 34, 1 << 45):
                blocks, per = bucket_count.grid(n, T1, sms)
                q, full = n // 4, sms * bucket_count.BLOCKS_PER_SM
                rounds = -(-q // per)
                assert blocks >= 1 and 32 <= per <= full_round and per % 32 == 0
                assert -(-rounds // blocks) * 4 * per + 6 < 2**31, (n, T1, sms)  # 32-bit shared counts
                assert q == 0 or (blocks - 1) * per < q  # every block has a round
                raised = -(-rounds // blocks) * 4 * per + 6 >= 2**31 if blocks == 1 else (
                    -(-rounds // (blocks - 1)) * 4 * per + 6 >= 2**31)  # the 2^31 rule needs them all
                if not raised:
                    assert blocks <= full  # no more than fill the card
                    assert blocks == 1 or blocks <= 2 * n // (T1 + 1), (n, T1, sms)  # adds stay small
                if per < full_round:  # a small stream: one short round a block
                    assert blocks == max(1, rounds)
                    assert 2 * -(-q // full_round) < max(1, min(full, 2 * n // (T1 + 1)))
                else:  # full rounds where they fill half the blocks the rules allow
                    assert blocks <= max(1, rounds) or raised  # every block has a round
                    assert 2 * rounds >= max(1, min(full, 2 * n // (T1 + 1))) or raised
    full = 132 * bucket_count.BLOCKS_PER_SM
    assert bucket_count.grid(383_778_816, 255, 132) == (full, full_round)  # the scale shape
    assert bucket_count.grid(67_584, 2049, 132) == (59, 288)  # a day: 59 short rounds, not 9 full
    assert bucket_count.grid(743_424, 255, 132) == (91, full_round)  # a window: one full round a block
    assert bucket_count.grid(0, 2049, 132)[0] == 1


def test_wrapper_geometry_matches_the_kernel():
    with open(CU) as f:
        src = f.read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kThreads"] == bucket_count.THREADS
    assert const["kBlocksPerSM"] == bucket_count.BLOCKS_PER_SM
    assert const["kThreads"] * const["kVec"] == bucket_count.ROUND
    assert "__launch_bounds__(kThreads, kBlocksPerSM)" in src
    assert "finish_kernel" not in src  # one launch a call
    a, b = map(int, re.search(r"constexpr size_t kMaxShared = (\d+) - (\d+);", src).groups())
    fits = [T1 for T1 in range(2, 1 << 16) if 4 * (1 << depth(T1)) + 4 * (T1 + 1) <= a - b]
    assert fits[-1] == bucket_count.SHARED_MAX_T1 == len(fits) + 1  # every T+1 up to it fits


def test_rotated_flush_adds_each_slot_once():
    """Mirror of the flush's rotated order: block g of G adds slot
    (j + rot) mod S for j < S, rot = g·S/G, so every slot once."""
    for S in (513, 1000, 2049, 25_087):
        for G in (1, 7, 59, 132):
            for g in {0, 1, G // 2, G - 1}:
                rot = g * S // G
                j = np.arange(S)
                s = np.where(j + rot < S, j + rot, j + rot - S)
                assert np.array_equal(np.sort(s), j), (S, G, g)
