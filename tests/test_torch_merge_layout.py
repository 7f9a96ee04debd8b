"""The design of the port's batched merge (``csrc/merge_cut.cu``), on the CPU.

The CUDA kernels run only on the card.  Their index arithmetic and their
float32 additions are mirrored here in numpy, add for add, and held to
``ref.merge_ref`` bit for bit:

- the long kernel: pass A's totals per group of keys (two pairs a lane,
  a warp's Hillis–Steele scan per chunk of 64, chunks carried), the block
  scan of the totals into group bases and ends, and for each cut one
  binary search over the group ends plus a rescan of one group — at the
  kernel's geometry and at a smaller one that gives groups of several
  chunks and threads that hold several groups;
- the resident kernel: the scan in the sort's tile order (warps, chunks,
  lanes) and one binary search a cut;

with ties, all-tied boundaries, n = 0, β = 1, β > k(T+1), targets that
land exactly on a cumulative value, ±0, ±inf and NaN boundaries, and int32
boundaries.  Also: the regime :func:`merge_cut.plan` gives for each
(k, T), the shared memory of both regimes, the magic division against
``//``, and the wrapper's constants against the kernel source.

Tolerance: exact (boundary bits, float32 sizes).
"""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import merge_cut, ref, tile_sort

CU = os.path.join(os.path.dirname(merge_cut.__file__), "csrc", "merge_cut.cu")
HEADER = os.path.join(os.path.dirname(merge_cut.__file__), "csrc", "radix_sort.cuh")
F = np.float32
PAD = 0xFFFFFFFF


def source(path: str = CU) -> str:
    with open(path) as f:
        return f.read()


def constant(name: str) -> int:
    return int(re.search(rf"{name} = (\d+);", source()).group(1))


# the long kernel's geometry, as csrc/merge_cut.cu sets it
CHUNK, MAX_GROUPS, CUT_ROUND, THREADS = (constant(n) for n in ("kChunk", "kMaxGroups", "kCutRound", "kLongThreads"))
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use (H100)


def resident_shapes(text: str, launcher: str) -> dict[int, tuple[int, int]]:
    """capacity -> (warps, items) of each ``case`` of a resident launcher."""
    pat = rf"case (\d+): return {launcher}<(\d+), (\d+)(?:, KV)?>"
    return {int(c): (int(w), int(i)) for c, w, i in re.findall(pat, text)}


RESIDENT_SHAPES = resident_shapes(source(), "run_resident_merge")


def resident_smem_bytes(cap: int) -> int:
    """``merge_smem``: the resident kv sort's ``resident_smem<W, ITEMS, true>``."""
    w, items = RESIDENT_SHAPES[cap]
    return 4 * (2 * w * 32 * items + w * 256 + 256 + 256 + 8 + w // 8 * 256 + w * 256)


def long_geometry(L: int) -> tuple[int, int]:
    """``(gsz, ngroups)`` as hk_merge_cut sets them: groups of kChunk keys,
    doubled until at most kMaxGroups of them cover L."""
    gsz = CHUNK
    while L // gsz > MAX_GROUPS:
        gsz *= 2
    return gsz, -(-L // gsz)


def long_smem_bytes(L: int) -> int:
    """``long_smem``: group bases and ends, a round of fulls, warp totals."""
    return 4 * (2 * long_geometry(L)[1] + CUT_ROUND + 1 + 32)


def magic(d: int) -> tuple[int, int]:
    """``make_divider``: ``l = ceil(log2 d)``, ``M = ceil(2^(32+l) / d)``,
    shift ``32 + l``."""
    l = (d - 1).bit_length()
    return -(-(1 << (32 + l)) // d), 32 + l


def warp_incl(v: np.ndarray) -> np.ndarray:
    """``warp_incl``: Hillis–Steele over 32 lanes, float32 adds."""
    v = v.astype(F).copy()
    for d in (1, 2, 4, 8, 16):
        up = v.copy()
        v[d:] = v[d:] + up[:-d]
    return v


def divide(x: np.ndarray, d: int) -> np.ndarray:
    M, shift = magic(d)
    return (x.astype(np.uint64) * np.uint64(M)) >> np.uint64(shift)


class Problem:
    """One merge problem as the kernels see it: flat boundaries, sizes and
    the stable (boundary, flat index) order."""

    def __init__(self, bounds: np.ndarray, sizes: np.ndarray):
        self.k, T1 = bounds.shape
        self.T = T1 - 1
        self.lreal = self.k * T1
        self.flat = bounds.reshape(-1)
        self.sizes = sizes.reshape(-1).astype(F)
        self.order = torch.argsort(torch.from_numpy(self.flat), stable=True).numpy().astype(np.int64)

    def mass(self, idx: np.ndarray) -> np.ndarray:
        """``mass_of``: sizes[src, b] at a left boundary, else 0."""
        idx = np.asarray(idx, np.int64)
        out = np.zeros(idx.shape, F)
        ok = idx < self.lreal
        src = divide(np.where(ok, idx, 0), self.T + 1).astype(np.int64)
        b = idx - src * (self.T + 1)
        ok &= b < self.T
        out[ok] = self.sizes[(src * self.T + b)[ok]]
        return out

    def step(self, total: F, beta: int) -> F:
        return F(total) / F(beta)


def chunk_sums(p: Problem, idx: np.ndarray):
    """``chunk_sums`` over 64 positions: lane l holds 2l and 2l+1."""
    m = p.mass(idx)
    m0, m1 = m[0::2], m[1::2]
    incl = warp_incl(m0 + m1)
    excl = np.concatenate([[F(0)], incl[:-1]]).astype(F)
    return incl, excl, m0


def long_model(bounds, sizes, beta, *, max_groups=MAX_GROUPS, threads=THREADS):
    """``long_merge_kernel`` on one problem: (bo, so)."""
    p = Problem(bounds, sizes)
    L = 1 << max(0, p.lreal - 1).bit_length()
    pairs = np.concatenate([p.order, np.arange(p.lreal, L)])  # argsort_pairs' indices
    gsz = CHUNK
    while L // gsz > max_groups:
        gsz *= 2
    ngroups = -(-L // gsz)

    def at(m):
        m = np.asarray(m)
        return np.where(m < L, pairs[np.minimum(m, L - 1)], PAD)

    lanes = np.arange(64)
    gtot = np.zeros(ngroups, F)
    for g in range(ngroups):  # pass A
        carry = F(0)
        for ch in range(0, gsz, CHUNK):
            incl, _, _ = chunk_sums(p, at(g * gsz + ch + lanes))
            carry = F(carry + incl[31])
        gtot[g] = carry
    # block scan: a run of groups a thread, warps of 32, the warps' totals
    per = -(-ngroups // threads)
    runs = [range(min(t * per, ngroups), min(t * per + per, ngroups)) for t in range(threads)]
    tot = np.zeros(threads, F)
    for t, r in enumerate(runs):
        for g in r:
            tot[t] = F(tot[t] + gtot[g])
    incl = np.concatenate([warp_incl(tot[w : w + 32]) for w in range(0, threads, 32)])
    excl = np.concatenate([np.concatenate([[F(0)], incl[w : w + 31]]) for w in range(0, threads, 32)]).astype(F)
    wsum = warp_incl(np.pad(incl[31::32], (0, 32 - threads // 32)))
    gbase, gend = np.zeros(ngroups, F), np.zeros(ngroups, F)
    for t, r in enumerate(runs):
        w = t // 32
        run = F(F(wsum[w - 1] if w else 0) + excl[t])
        for g in r:
            gbase[g] = run
            run = F(run + gtot[g])
            gend[g] = run
    total = gend[-1]
    step = p.step(total, beta)
    full = np.zeros(beta + 1, F)
    bo = np.empty(beta + 1, np.int64)
    bo[0] = pairs[0]
    for j in range(1, beta + 1):
        if j == beta:
            full[j], bo[j] = total, pairs[p.lreal - 1]
            continue
        t = F(F(j) * step)
        lo, hi = 0, ngroups - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if gend[mid] > t or (mid + 1) * gsz >= p.lreal:
                hi = mid
            else:
                lo = mid + 1
        base, prev, carry = gbase[lo], (gend[lo - 1] if lo else F(0)), F(0)
        for ch in range(0, gsz, CHUNK):
            m = lo * gsz + ch + 2 * np.arange(32)
            idx = at(lo * gsz + ch + lanes)
            inc, exc, m0 = chunk_sums(p, idx)
            c0 = (base + (carry + (exc + m0).astype(F)).astype(F)).astype(F)
            c1 = (base + (carry + inc).astype(F)).astype(F)
            gt0 = (m >= p.lreal - 1) | (c0 > t)
            gt1 = (m + 1 >= p.lreal - 1) | (c1 > t)
            hit = np.flatnonzero(gt0 | gt1)
            if hit.size:
                f = hit[0]
                if gt0[f]:
                    bo[j], full[j] = idx[2 * f], (c1[f - 1] if f else prev)
                else:
                    bo[j], full[j] = idx[2 * f + 1], c0[f]
                break
            prev, carry = c1[31], F(carry + inc[31])
        else:
            raise AssertionError("the group holds no cut")
    return p.flat[bo], np.diff(full).astype(F)


def resident_model(bounds, sizes, beta):
    """``resident_merge_kernel`` on one problem: (bo, so)."""
    p = Problem(bounds, sizes)
    cap = merge_cut.plan(p.k, p.T, "resident")
    W, items = RESIDENT_SHAPES[cap]
    m = np.zeros(cap, F)
    m[: p.lreal] = p.mass(p.order)
    tile = m.reshape(W, items, 32)  # warp, chunk, lane: the sort's tile order
    vals = np.zeros_like(tile)
    wtot = np.zeros(32, F)
    for w in range(W):
        carry = F(0)
        for c in range(items):
            v = warp_incl(tile[w, c])
            vals[w, c] = (carry + v).astype(F)
            carry = F(carry + v[31])
        wtot[w] = carry
    wtot = warp_incl(wtot)
    for w in range(W):
        vals[w] = (F(wtot[w - 1] if w else 0) + vals[w]).astype(F)
    cum = vals.reshape(-1)[: p.lreal]
    total = cum[-1]
    step = p.step(total, beta)
    full = np.zeros(beta + 1, F)
    at = np.zeros(beta + 1, np.int64)
    full[beta], at[beta] = total, p.lreal - 1
    for j in range(1, beta):
        t = F(F(j) * step)
        lo, hi = 0, p.lreal - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if cum[mid] <= t:
                lo = mid + 1
            else:
                hi = mid
        at[j], full[j] = lo, (cum[lo - 1] if lo else F(0))
    return p.flat[p.order[at]], np.diff(full).astype(F)


def summaries(rng, k, T, *, lo=1, hi=5000, ties=False):
    n = rng.integers(lo, hi, size=k)
    sizes = np.diff(ref.masked_cuts(n, T), axis=-1).astype(F)
    b = rng.normal(size=(k, T + 1)) * 10
    if ties:
        b = np.round(b / 5)
    return np.sort(b, axis=-1).astype(F), sizes


def cases():
    """(name, bounds (k, T+1), sizes (k, T), β)."""
    rng = np.random.default_rng(16)
    out = []
    for name, k, T, beta, ties in [
        ("pull-up", 2, 32, 32, False),
        ("query", 8, 40, 12, False),
        ("ties", 6, 30, 17, True),
        ("beta=1", 3, 9, 1, False),
        ("beta > k(T+1)", 3, 5, 40, True),
        ("one summary", 1, 64, 7, False),
        ("long rows", 5, 130, 33, True),
    ]:
        b, s = summaries(rng, k, T, ties=ties)
        out.append((name, b, s, beta))
    out.append(("all tied", np.full((4, 9), 3.0, F), np.full((4, 8), 10.0, F), 5))
    b, s = summaries(rng, 5, 16)
    out.append(("n = 0", b, np.zeros_like(s), 6))
    # exact targets: 4 × 12 unit buckets, β = 8 puts t_j on cum values
    b, _ = summaries(rng, 4, 12)
    out.append(("targets on cum values", b, np.ones((4, 12), F), 8))
    b, s = summaries(rng, 4, 20, ties=True)
    b[0, -1], b[1, 0], b[2, 5:] = np.inf, -np.inf, np.nan
    b[3, :3] = [-0.0, 0.0, -0.0]
    out.append(("±0, ±inf, NaN", b, s, 9))
    # zero-mass duplicate rows, as the k padding packs them
    b, s = summaries(rng, 3, 16)
    out.append(("k padding", np.concatenate([b, np.repeat(b[-1:], 5, 0)]), np.concatenate([s, np.zeros((5, 16), F)]), 7))
    return out


def as_int32(bounds: np.ndarray) -> np.ndarray:
    return np.round(np.nan_to_num(bounds.astype(np.float64), posinf=2**31 - 1, neginf=-(2**31))).clip(-(2**31), 2**31 - 1).astype(np.int32)


def want(bounds, sizes, beta):
    rb, rs = ref.merge_ref(torch.from_numpy(bounds)[None], torch.from_numpy(sizes)[None], beta)
    return rb[0].numpy(), rs[0].numpy()


def assert_bits(got, wanted):
    (gb, gs), (wb, ws) = got, wanted
    assert gb.dtype == wb.dtype
    assert np.array_equal(gb.view(np.int32), wb.view(np.int32))
    assert np.array_equal(gs.view(np.int32), ws.view(np.int32))


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("name,bounds,sizes,beta", cases(), ids=[c[0] for c in cases()])
def test_long_model_is_merge_ref_bit_for_bit(name, bounds, sizes, beta, dtype):
    if dtype == "i32":
        bounds = as_int32(bounds)
    wanted = want(bounds, sizes, beta)
    assert_bits(long_model(bounds, sizes, beta), wanted)
    # groups of several chunks, threads holding several groups
    assert_bits(long_model(bounds, sizes, beta, max_groups=2, threads=64), wanted)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("name,bounds,sizes,beta", cases(), ids=[c[0] for c in cases()])
def test_resident_model_is_merge_ref_bit_for_bit(name, bounds, sizes, beta, dtype):
    if dtype == "i32":
        bounds = as_int32(bounds)
    assert_bits(resident_model(bounds, sizes, beta), want(bounds, sizes, beta))


def test_plan_regimes():
    limit = tile_sort.KV_RESIDENT_LIMIT
    for k, T, cap in [
        (2, 32, 256),        # a pull-up of 32-bucket leaves
        (2, 2032, 4096),     # a paper pull-up
        (17, 512, 16384),    # summarize_tiles of a log-analytics day
        (32, 256, 16384),    # a registry query at k_pad = 32
        (8, 2032, 16384),    # a paper query at k_pad = 8
        (1, limit - 1, limit),
        (64, 255, limit),    # k(T+1) = 16,384
        (5, 3276, 0),        # 16,385
        (16, 2032, 0),       # a paper query at k_pad = 16
        (32, 2032, 0),       # the timed shape
    ]:
        assert merge_cut.plan(k, T) == cap, (k, T)
        assert merge_cut.plan(k, T, "long") == 0
        if cap:
            assert merge_cut.plan(k, T, "resident") == cap
        else:
            with pytest.raises(ValueError):
                merge_cut.plan(k, T, "resident")
    with pytest.raises(ValueError):
        merge_cut.plan(2, 8, "onesweep")


def test_shared_memory_fits_every_capacity():
    kv_caps = resident_shapes(source(HEADER), "run_resident")
    assert RESIDENT_SHAPES == {c: s for c, s in kv_caps.items() if c <= tile_sort.KV_RESIDENT_LIMIT}
    assert tuple(RESIDENT_SHAPES) == tile_sort.RESIDENT_CAPS[:-1]
    assert max(RESIDENT_SHAPES) == tile_sort.KV_RESIDENT_LIMIT
    for cap, (w, items) in RESIDENT_SHAPES.items():
        assert cap == w * 32 * items
        assert resident_smem_bytes(cap) <= SMEM_LIMIT, cap
        assert 32 + w * 32 + 1 <= w * 256  # warp totals and a round of fulls in the counters
    assert resident_smem_bytes(16384) == 202_784
    for lg in range(1, 32):
        gsz, ngroups = long_geometry(1 << lg)
        assert ngroups <= MAX_GROUPS and gsz % CHUNK == 0
        assert ngroups * gsz >= 1 << lg
        assert long_smem_bytes(1 << lg) <= 48 * 1024


def test_magic_division_is_floor_division():
    rng = np.random.default_rng(5)
    xs = np.concatenate([np.arange(5000), rng.integers(0, 2**31, size=20_000), [2**31 - 1, 2**31 - 2, 2**30]])
    divisors = list(range(2, 300)) + [2033, 2049, 257, 513, 4097, 65_537, 2**20 + 1, 2**30, 2**30 + 1, 2**31 - 1, 2**31]
    divisors += rng.integers(2, 2**31, size=200).tolist()
    for d in divisors:
        M, shift = magic(int(d))
        assert M <= 2**33
        near = np.concatenate([xs, d * np.arange(0, 2**31 // d, max(1, 2**31 // d // 500)) + d - 1])
        near = near[near < 2**31]
        got = (near.astype(np.uint64) * np.uint64(M)) >> np.uint64(shift)
        assert np.array_equal(got, near.astype(np.uint64) // np.uint64(d)), d


def test_kernel_source_keeps_the_mirrored_formulas():
    cu = source()
    assert THREADS % 32 == 0 and THREADS // 32 <= 32  # warp totals in one warp
    assert "while (a.L / a.gsz > kMaxGroups) a.gsz <<= 1;" in cu
    assert "return Divider{(p + d - 1) / d, 32 + l};" in cu
    assert "2 * (size_t)ngroups + kCutRound + 1 + 32" in cu
    assert "return hk::resident_smem<W, ITEMS, true>();" in cu
    assert "static_assert(smem <= 232448" in cu
