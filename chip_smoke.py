#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, timed;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time kernel, plain version and the
   PyTorch library call computing the same function;
3. the main path at the paper's configuration: ``HistogramStore`` with
   T=2032 on the card, ``ingest_many`` of 31 × 200,000 seeded Gumbel values,
   ``query_many`` of all 496 windows at β=254 — bit-equal to the same run on
   the CPU, and every kernel of the path launched;
4. scale: 365 partitions × 2^20 values, T=2032, 1,000 random windows, eight
   of them held to the reported ε against an exact sort of their values;
5. report: the kernels JSON line, throughput/latency, the card.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Writes nothing outside ``build/`` (the kernel build).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
T = 2032
BETA = 254


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the float32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def device_breakdown(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time, device kernel time by
    name (top 6) and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            if t > 0:
                kern[e.key] = kern.get(e.key, 0.0) + t / 1e3
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall * 1e3,
        "device_ms": busy,
        "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
        "top_kernels_ms": {k[:60]: v for k, v in top},
    }


def same_sorted(a, b) -> bool:
    """torch.equal on the non-NaN entries (±0 equal) and one NaN mask."""
    import torch

    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def max_abs(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return float(d.max())


def summary_inputs(rng, Q: int, k: int, lo: int, hi: int, ties: bool, device):
    """Q problems of k exact T-bucket summaries: sorted boundaries, sizes
    of the masked cuts of a random partition length in [lo, hi)."""
    import torch

    from repro_torch.kernels import ref

    n = rng.integers(lo, hi, size=Q * k)
    sizes = np.diff(ref.masked_cuts(n, T), axis=-1).astype(np.float32)
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    b = torch.randn((Q, k, T + 1), generator=g, device=device) * 100.0
    if ties:
        b = torch.round(b / 25.0)
    b = torch.sort(b, dim=-1).values.contiguous()
    return b, torch.from_numpy(sizes.reshape(Q, k, T)).to(device)


# ----------------------------------------------------------------- phase 2


def check_kernels(dev, rng) -> dict:
    """Each kernel against its plain version on the card; returns the
    per-kernel measurements of the kernels line."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ref

    out = {}
    # -- row sort at the scale path's shape: 256 rows x 2^20 float32
    rows, n = 256, 1 << 20
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = -torch.log(-torch.log(torch.rand((rows, n), generator=g, device=dev)))
    ns = np.full(rows, n)
    got = kernels.summarize_rows(x, ns, T)
    want = ref.summarize_rows_ref(x, ns, T)
    assert torch.equal(got, want), "row sort: boundaries differ from the plain version"
    full = kernels.sort_rows(x)
    assert same_sorted(full, torch.sort(x, dim=-1).values), "row sort: rows differ"
    err = max_abs(got, want)
    ms = cuda_ms(lambda: kernels.summarize_rows(x, ns, T))
    plain = cuda_ms(lambda: ref.summarize_rows_ref(x, ns, T))
    lib = cuda_ms(lambda: torch.sort(x, dim=-1))
    sort_ms = cuda_ms(lambda: kernels.sort_rows(x))
    b, by = bound_ms(4.0 * rows * n + 4.0 * rows * (T + 1), rows * n * np.log2(n))
    out["tile_sort"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
    log(f"row sort 256x2^20 f32: summarize {ms:.3f} ms, full sort {sort_ms:.3f} ms, "
        f"plain {plain:.3f} ms, torch.sort {lib:.3f} ms, bound {b:.3f} ms ({by})")
    del x, full, got, want
    # -- paper-config rows (32 x 2^18), int32 rows with ties and extremes,
    #    float32 rows with ±0, ±inf and NaN, and a width that is no power of 2
    cases = []
    xi = torch.randint(-50, 50, (64, 1 << 16), generator=g, device=dev, dtype=torch.int32)
    xi[:, :7] = torch.tensor([-(2**31), 2**31 - 1, 0, -1, 1, 2**31 - 1, -(2**31)], dtype=torch.int32)
    cases.append(("i32 ties", xi))
    xf = torch.round(torch.randn((64, 1 << 16), generator=g, device=dev) * 3.0)
    special = torch.tensor([-0.0, 0.0, float("nan"), float("inf"), -float("inf"), -0.0], device=dev)
    idx = torch.randint(0, 1 << 16, (64, 4096), generator=g, device=dev)
    xf.scatter_(1, idx, special[torch.randint(0, 6, (64, 4096), generator=g, device=dev)])
    cases.append(("f32 ±0/NaN", xf))
    cases.append(("f32 32x2^18", torch.randn((32, 1 << 18), generator=g, device=dev)))
    cases.append(("f32 width 3000", torch.randn((5, 3000), generator=g, device=dev)))
    cases.append(("f32 width 1", torch.randn((3, 1), generator=g, device=dev)))
    for name, xc in cases:
        assert same_sorted(kernels.sort_rows(xc), torch.sort(xc, dim=-1).values), f"row sort {name}"
        nsc = rng.integers(1, xc.shape[1] + 1, size=xc.shape[0])
        Tc = 97 if xc.shape[1] > 97 else 1
        a, w = kernels.summarize_rows(xc, nsc, Tc), ref.summarize_rows_ref(xc, nsc, Tc)
        assert same_sorted(a, w), f"row summarize {name}"
    log(f"row sort: {len(cases) + 1} cases equal to the plain version")

    # -- kv sort at the merge's shapes: pull-up (512 x 4096), query (1000 x 65536)
    for Q, L in [(512, 4096), (1000, 65536)]:
        keys = torch.round(torch.randn((Q, L), generator=g, device=dev) * 40.0)
        keys[:, :3] = torch.tensor([-0.0, 0.0, -0.0], device=dev)
        vals = torch.arange(Q * L, device=dev, dtype=torch.float32).reshape(Q, L)
        ko, vo = kernels.sort_kv(keys, vals)
        rk, rv = ref.sort_kv_ref(keys, vals)
        assert torch.equal(ko, rk) and torch.equal(vo, rv), f"kv sort {Q}x{L}: order differs"
        assert torch.equal(torch.signbit(ko), torch.signbit(rk)), "kv sort: key bits differ"
    err = max(max_abs(ko, rk), max_abs(vo, rv))
    ms = cuda_ms(lambda: kernels.sort_kv(keys, vals))
    plain = cuda_ms(lambda: ref.sort_kv_ref(keys, vals))
    lib = cuda_ms(lambda: torch.sort(keys, dim=-1, stable=True))
    b, by = bound_ms(16.0 * Q * L, Q * L * np.log2(L))
    out["sort_kv"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
    log(f"kv sort 1000x65536: {ms:.3f} ms, plain {plain:.3f} ms, torch.sort {lib:.3f} ms, bound {b:.3f} ms")
    del keys, vals, ko, vo, rk, rv

    # -- merge: pull-up, query, ties, int32 boundaries, beta = 1
    merge_cases = [
        ("pull-up Q=512 k=2 beta=2032", 512, 2, T, 200_000, 200_001, False),
        ("query Q=1000 k=32 beta=254", 1000, 32, BETA, 150_000, 250_000, False),
        ("ties Q=64 k=16 beta=254", 64, 16, BETA, T, 400_000, True),
        ("beta=1 Q=8 k=5", 8, 5, 1, T, 5000, False),
    ]
    for name, Q, k, beta, lo, hi, ties in merge_cases:
        bnd, sz = summary_inputs(rng, Q, k, lo, hi, ties, dev)
        bo, so = kernels.merge_batched(bnd, sz, beta)
        rb, rs = ref.merge_ref(bnd, sz, beta)
        assert float(sz.sum(dim=(1, 2)).max()) < 2**24
        assert torch.equal(bo, rb) and torch.equal(so, rs), f"merge {name}: not bit-equal"
        bi = bnd.to(torch.int32)
        bo, so = kernels.merge_batched(bi, sz, beta)
        rb, rs = ref.merge_ref(bi, sz, beta)
        assert torch.equal(bo, rb) and torch.equal(so, rs), f"merge {name} int32: not bit-equal"
        if name.startswith("query"):
            bnd_q, sz_q, beta_q = bnd, sz, beta
            # and against the plain version on the CPU, for 64 problems
            kb, ks = kernels.merge_batched(bnd[:64].contiguous(), sz[:64].contiguous(), beta)
            cb, cs = ref.merge_ref(bnd[:64].cpu(), sz[:64].cpu(), beta)
            assert torch.equal(kb.cpu(), cb) and torch.equal(ks.cpu(), cs), f"merge {name} vs CPU"
        elif name.startswith("pull-up"):
            pull_ms = cuda_ms(lambda: kernels.merge_batched(bnd, sz, beta))
            log(f"merge {name}: {pull_ms:.3f} ms")
    golden = merge_golden(dev)
    rb, rs = kernels.merge_batched(bnd_q, sz_q, beta_q)
    wb, ws = ref.merge_ref(bnd_q, sz_q, beta_q)
    err = max(max_abs(rb, wb), max_abs(rs, ws))
    ms = cuda_ms(lambda: kernels.merge_batched(bnd_q, sz_q, beta_q))
    plain = cuda_ms(lambda: ref.merge_ref(bnd_q, sz_q, beta_q))
    Q, k, T1 = bnd_q.shape
    L = Q * k * T1
    b, by = bound_ms(4.0 * L + 4.0 * Q * k * (T1 - 1) + 4.0 * Q * (2 * beta_q + 1), L * np.log2(k * T1))
    out["merge_cut"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)
    log(f"merge query 1000x32x2033 beta=254: {ms:.3f} ms, plain {plain:.3f} ms, bound {b:.3f} ms; "
        f"{len(merge_cases)} cases x 2 dtypes + {golden} golden bit-equal")
    return out


GOLDEN = [  # (seed, k, T, beta, duplicate-heavy), as the JAX package's parity set
    (0, 1, 4, 2, False),
    (1, 3, 16, 16, False),
    (2, 7, 15, 5, False),
    (3, 2, 8, 1, False),
    (4, 3, 41, 12, True),
    (5, 5, 12, 7, True),
    (6, 1, 7, 7, True),
    (7, 4, 20, 19, False),
]


def merge_golden(dev) -> int:
    import torch

    from repro_torch.core import build_exact, merge_histograms_sequential
    from repro_torch.kernels import merge_batched, ref

    for seed, k, Tg, beta, dup in GOLDEN:
        rng = np.random.default_rng(seed)
        hs = []
        for _ in range(k):
            n = int(rng.integers(Tg, 400))
            v = (rng.integers(0, 8, size=n) if dup else rng.normal(size=n) * 5).astype(np.float32)
            hs.append(build_exact(v, Tg))
        b = torch.stack([h.boundaries for h in hs])[None]
        s = torch.stack([h.sizes for h in hs])[None]
        bo, so = merge_batched(b.to(dev), s.to(dev), beta)
        rb, rs = ref.merge_ref(b, s, beta)
        assert torch.equal(bo.cpu(), rb) and torch.equal(so.cpu(), rs), f"golden {seed}"
        hq = merge_histograms_sequential(hs, beta)
        np.testing.assert_allclose(bo[0].cpu().numpy(), hq.boundaries.numpy(), rtol=1e-6)
        np.testing.assert_allclose(so[0].cpu().numpy(), hq.sizes.numpy(), atol=1e-2)
    return len(GOLDEN)


# ----------------------------------------------------------------- phase 3


def paper_config(dev) -> tuple[dict, dict]:
    """The main path at the paper's configuration, on the card and on the
    CPU; returns the launch counts of the card's run and its timings."""
    from repro_torch import kernels
    from repro_torch.configs import paper_logstats
    from repro_torch.core import HistogramStore

    cfg = paper_logstats.config()
    rng = np.random.default_rng(cfg.seed)
    parts = {
        p: rng.gumbel(size=cfg.tuples_per_partition).astype(np.float32)
        for p in range(cfg.num_partitions)
    }
    wins = [(lo, hi) for lo in range(cfg.num_partitions) for hi in range(lo, cfg.num_partitions)]
    assert len(wins) == 496 and cfg.T == T and cfg.beta == BETA

    def run(device):
        store = HistogramStore(num_buckets=cfg.T, device=device)
        t0 = time.perf_counter()
        store.ingest_many(parts)
        t1 = time.perf_counter()
        ans = store.query_many(wins, cfg.beta)
        t2 = time.perf_counter()
        return store, ans, t1 - t0, t2 - t1

    cpu_store, cpu_ans, _, _ = run("cpu")
    kernels.reset_launches()
    gpu_store, gpu_ans, t_ing, t_q = run(dev)
    launches = kernels.reset_launches()
    prof = device_breakdown(lambda: run(dev))  # a second run, traced
    for pid in parts:
        a, b = gpu_store.summaries[pid], cpu_store.summaries[pid]
        assert np.array_equal(a.boundaries, b.boundaries) and np.array_equal(a.sizes, b.sizes), pid
    for (hg, eg), (hc, ec), (lo, hi) in zip(gpu_ans, cpu_ans, wins):
        assert np.array_equal(hg.boundaries, hc.boundaries), (lo, hi)
        assert np.array_equal(hg.sizes, hc.sizes) and eg == ec, (lo, hi)
        assert np.all(np.isfinite(hg.boundaries)) and hg.boundaries.shape == (cfg.beta + 1,)
        n = sum(len(parts[p]) for p in range(lo, hi + 1))
        assert float(hg.sizes.astype(np.float64).sum()) == n
    for name, c in launches.items():
        assert c > 0, f"main path never launched {name}: {launches}"
    log(f"paper config: 31 partitions x 200000, 496 windows bit-equal to the CPU run; "
        f"ingest {t_ing:.3f} s, query_many {t_q:.3f} s; launches {launches}")
    log(f"paper config traced: {json.dumps(prof)}")
    return launches, {"ingest_s": t_ing, "query_many_s": t_q, "traced": prof}


# ----------------------------------------------------------------- phase 4


def true_occupancy(values, boundaries) -> np.ndarray:
    """Exact per-bucket counts of ``values`` under ``boundaries`` (last
    bucket right-closed), from ``torch.sort`` — independent of the port's
    kernels, which it checks."""
    import torch

    v = torch.sort(values).values
    lo = torch.searchsorted(v, boundaries[:-1]).double()
    hi = torch.searchsorted(v, boundaries[1:]).double()
    sizes = (hi - lo).cpu().numpy()
    sizes[-1] += float((v == boundaries[-1]).sum())
    return sizes


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scale(dev, days: int = 365, n: int = 1 << 20) -> dict:
    import torch

    from repro_torch.core import HistogramStore

    rng = np.random.default_rng(SEED + 1)
    data = rng.gumbel(size=(days, n)).astype(np.float32)
    parts = {p: data[p] for p in range(days)}
    store = HistogramStore(num_buckets=T, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    store.ingest_many(parts)
    sync(dev)
    t_ing = time.perf_counter() - t0
    lo = rng.integers(0, days, size=1000)
    hi = np.minimum(days - 1, lo + rng.integers(0, days, size=1000))
    wins = [(int(a), int(b)) for a, b in zip(lo, hi)]
    t0 = time.perf_counter()
    ans = store.query_many(wins, BETA)
    t_qm = time.perf_counter() - t0
    prof = {
        "ingest": device_breakdown(
            lambda: HistogramStore(num_buckets=T, device=dev).ingest_many(parts)
        ),
        "query_many": device_breakdown(
            lambda: store.query_many([(a, b) for a, b in wins], BETA + 1)
        ),
    }
    log(f"scale traced: {json.dumps(prof)}")
    worst = 0.0
    for i in rng.choice(len(wins), size=8, replace=False):
        (a, b), (h, eps) = wins[i], ans[i]
        vals = torch.from_numpy(data[a : b + 1].reshape(-1)).to(dev)
        N = vals.numel()
        sizes = h.sizes.astype(np.float64)
        ulp = float(np.spacing(np.float32(N)))
        assert abs(sizes.sum() - N) <= BETA * ulp, (a, b, sizes.sum(), N)
        true = true_occupancy(vals, torch.from_numpy(h.boundaries).to(dev))
        assert true.sum() == N
        dev_max = float(np.abs(true - N / BETA).max())
        assert dev_max <= eps, (a, b, dev_max, eps)
        worst = max(worst, dev_max / eps)
        del vals
    # single-window latency: uncached query() calls, each one merge launch
    lat = []
    for a, b in zip(rng.integers(0, days, size=200), rng.integers(0, days, size=200)):
        a, b = int(min(a, b)), int(max(a, b))
        t0 = time.perf_counter()
        store.query(a, b, BETA - 1)  # a β not cached by query_many
        lat.append((time.perf_counter() - t0) * 1e3)
    out = {
        "ingest_values_per_s": days * n / t_ing,
        "ingest_s": t_ing,
        "query_many_1000_s": t_qm,
        "query_p50_ms": float(np.percentile(lat, 50)),
        "query_p99_ms": float(np.percentile(lat, 99)),
        "worst_dev_over_eps": worst,
        "traced": prof,
    }
    log(f"scale: {days} x {n} values ingested in {t_ing:.3f} s; 1000 windows in {t_qm:.3f} s; "
        f"8 windows within eps (worst |true - N/beta| / eps = {worst:.4f})")
    return out


def card() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import kernels
        from repro_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the port is not importable beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    failed = []

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            res = fn()
            log(f"[phase {name}] ok in {time.perf_counter() - t0:.1f} s")
            return res
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            log(f"[phase {name}] FAILED after {time.perf_counter() - t0:.1f} s")
            failed.append(name)
            return None

    build_s = phase("1 build", kernels.build)
    if build_s is None:
        return 1
    for src in _lib.KERNELS.values():
        with open(os.path.join(_lib.build_dir(), src[:-3] + ".log")) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        log(f"{src}: " + " | ".join(ptxas[:6]))
    meas = phase("2 kernels vs plain", lambda: check_kernels(dev, rng))
    main_path = phase("3 paper config", lambda: paper_config(dev))
    big = phase("4 scale", lambda: scale(dev))
    if failed:
        log(f"chip_smoke: phases failed: {failed}")
        return 1
    launches, times = main_path
    replaces = {
        "tile_sort": ("src/repro_torch/kernels/csrc/row_sort.cu", "src/repro/kernels/tile_sort.py:119"),
        "sort_kv": ("src/repro_torch/kernels/csrc/kv_sort.cu", "src/repro/kernels/tile_sort.py:125"),
        "merge_cut": ("src/repro_torch/kernels/csrc/merge_cut.cu", "src/repro/kernels/merge_cut.py:46"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0], "replaces": replaces[name][1],
         "launches": launches[name], **meas[name]}
        for name in replaces
    ]}
    log(json.dumps(line))
    log(json.dumps({"build_s": build_s, "paper": times, "scale": big}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
