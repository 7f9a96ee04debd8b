#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, timed;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time kernel, plain version and the
   PyTorch library call computing the same function (the bucket count's
   edge cases here, its scale shape in phase 4; the merge in both its
   regimes, resident and long, bit for bit in float32 and int32, with
   non-finite boundaries, n = 0 problems and β > k(T+1));
   2b. the sorts' crossover sweep (row lengths 2^12 .. 2^20 at 2^28 keys,
   resident and onesweep where both apply) and the main path's exact sort
   shapes, uniform and skewed (phase 9's single rows of 2^28 and
   28,311,552 values among them), each held to its plain version and
   timed beside ``torch.sort``;
   2c. the bucket count at the main path's three shapes (a day, a window,
   a registry window): device µs, wall µs and launches a call over 100
   back-to-back calls;
   and the tile Summarizer over streams holding NaN, ±inf and ±0,
   bit-equal to its CPU run;
   2d. the decode attention kernel at the served cell's shape (104 rows, a
   bfloat16 cache of 1,152 positions, the token at 1,088) against the
   plain body (one bfloat16 ulp), its ms beside its byte bound and the
   plain body's ms, and wall and device µs a call over 100 calls;
3. the main path at the paper's configuration: ``HistogramStore`` with
   T=2032 on the card, ``ingest_many`` of 31 × 200,000 seeded Gumbel values,
   ``query_many`` of all 496 windows at β=254 — bit-equal to the same run on
   the CPU, and every kernel of the path launched;
4. scale: 365 partitions × 2^20 values, T=2032, 1,000 random windows, eight
   of them held to the reported ε against an exact sort of their values;
   the bucket count over all 3.8e8 values against one 255-boundary answer,
   bit-equal to its plain version, and timed, then at the same shape over
   one repeated value and over b_T only;
5. log analytics (the tile Summarizer, ``repro_torch.kernels.ops``): 31
   ragged days of lognormal latencies, ``summarize_tiles`` bit-equal to its
   CPU run, ``ingest_summary`` into a T=2048 store, all 496 windows at
   β=254; every day and window held with ``bucket_sizes`` (equal to an
   independent sort count) to its composed bound;
6. the registry (``TenantRegistry``): 256 tenants × 31 days × 65,536
   values through ``ingest_async`` + ``flush`` into a shared arena, a
   dashboard refresh of 256 windows in one merge with zero host row
   copies, 1,000 random windows, the first 8 tenants bit-equal to a CPU
   registry, 32 windows' true occupancy within ε;
8. the serving plane (``repro_torch.serve.HistogramService``; it runs
   before phase 7, so that its merge shapes join phase 7's record): 64
   metrics × 31 daily windows × 65,536 lognormal values recorded by a
   primary (one metric through ``record``, the rest through
   ``record_async`` + ``flush``) that ships its WAL to a replica-role
   service; the replica's ``sync``; 1,000 random windows on both,
   bit-equal, zero drift, none degraded; 10,000 subscriptions over 256
   windows and two ticks, each one merge dispatch (one ``merge_cut``
   launch) whose every push is bit-equal to a cold pull; a
   ``TelemetryHub`` dashboard and a ``StragglerDetector`` that flags the
   slow host of 8; ``close()`` without a checkpoint and recovery from the
   WAL, bit-equal; a checkpoint and ``promote`` of the replica fencing the
   old primary; then the same sequence on the CPU for 4 metrics,
   bit-equal to the card's answers;
9. the distributed and training plane (``repro_torch.core.distributed``,
   telemetry's ``grad_quantile``, ``repro_torch.optim``,
   ``repro_torch.data``; it runs before phase 7 too) on an NCCL group of
   one rank, its rendezvous a ``FileStore`` in ``build/``:
   ``distributed_histogram`` of 2^28 seeded Gumbel values (T=4096,
   β=254) and ``distributed_histogram_hierarchical`` of the same values
   (tile 8,192, T 512 → 4,096 → 4,096 → 254), each held against an exact
   sort to its composed bound, and again at 2^22 values bit-equal to the
   CPU; the Summarizer of the 2^28 shard and of every gradient leaf equal
   to ``torch.sort`` at its cuts; a SmolLM-135M gradient tree (272 leaves, 1.35e8 values) through
   ``grad_quantile`` (rank error within 2N/T of an exact count), quantile
   ``clip_grads`` + one ``adamw_update`` and ``compress_grads`` (sparse +
   residual equal to the gradient), without a mesh and with it;
   ``LengthBucketer`` over 64 shards × 2^20 document lengths, bit-equal
   to a CPU fit; every call's device ms from CUDA events, the all-gather's,
   and the device-level merge (Q = 1, long) split into its kv sort and its
   scan and cut;
10. model serving (``repro_torch.models``, ``serve.Engine``,
   ``launch.serve``; before phase 7 too) at Qwen3-8B's full width and
   depth (36 layers, d 4096, 8.19e9 float32 parameters from a seeded
   generator on the card, bfloat16 compute): ``generate`` of 4 ragged
   prompts (37–512 tokens, 32 new each) and of one alone, prefill and a
   decode step timed and traced; decode against prefill (float32 and
   bfloat16); bfloat16 logits against float32; the smoke configs of
   qwen3-8b and gemma2-9b on the card against the CPU; ``calibrate`` of
   4 × (2, 512) tokens (16.8 M |hidden| values: each batch's summary, the
   row sort, bit-equal to the CPU, the merge to the plain merge, the clip
   within its rank bound of an exact sort); the serve launcher at full
   width with a metrics sidecar and a replica in ``build/serve-*``
   (removed after), the replica's answer bit-equal to the primary's; the
   phase's peak device memory;
11. training (``models.loss_fn``, ``repro_torch.train``, ``checkpoint``,
   ``launch.train``; before phase 7 too) at SmolLM-135M's full width and
   depth (30 layers, d 576, vocab 49,152, tied, bfloat16 compute,
   ``remat_policy="full"``), seq 2,048 × batch 16, quantile clipping and
   compression at ρ = 0.01: one float32 step at the smoke widths of
   smollm-135m and qwen3-8b on the card against the CPU; a ``Trainer`` of
   8 steps checkpointing every 4 in ``build/train-*`` (removed after), then
   ``LATEST`` back at 4 and a second ``Trainer`` resuming to 8, its losses
   equal within 1e-4; the first step's gradient tree (1.35e8 values)
   through the card's ``grad_quantile``: every leaf's summary, the merged
   boundaries and the clipping threshold bit-equal to the plain versions,
   the merged sizes within the float32 scan's error bound (above 2^24
   mass the scans round in different orders), both thresholds within
   Theorem 1 of an exact count; a step timed and traced (its device time
   by kind), a checkpoint saved and restored, the step's peak memory and
   bound; the train launcher at full width in a subprocess;
12. MoE and hybrid Mamba serving (``models.moe``, ``models.mamba``,
   ``serve.Engine``, ``launch.serve``; before phase 7 too) at full width,
   depth cut: DBRX-132B with 2 of its 40 layers (7.75e9 float32
   parameters) and Jamba-v0.1 with one repeat of slots 2–5 of its
   8-layer super-block (every layer kind, 6.88e9 parameters), bfloat16:
   each model's ``generate`` of 4 ragged prompts and one alone, prefill
   and a decode step timed and traced (device ms by kernel kind), decode
   against prefill dropless, bfloat16 against float32; ``calibrate`` on
   DBRX; the smoke configs of dbrx, llama4-maverick and jamba card against
   CPU, with a train step each; the serve launcher at smoke width;
13. the last model families (``models.rwkv``, the whisper encoder and
   cross-attention, the pixtral vision frontend; ``serve.Engine``,
   ``launch.serve``; before phase 7 too) at full width, bfloat16:
   RWKV-6-7B at full depth (32 layers, 7.53e9 parameters; the prefill
   traced over 2 layers), Whisper-medium at full depth (24 + 24 layers,
   1,500 seeded frames in every prefill and forward, zero frames through
   ``generate``) and Pixtral-12B at full depth (40 layers, 1.22e10
   parameters; 1,024 bfloat16 patch embeddings ahead of the text in every
   prefill and forward, ``generate`` text only): each model's phase 12
   steps and ``calibrate`` of 2 × (2, 512) tokens (with frames or
   patches); the three smoke configs card against CPU with a train step
   each; the serve launcher at smoke width;
14. the dry-run against the card (``launch.dryrun``, ``launch.dryrun_core``,
   ``examples``; before phase 7 too): a. the dry-run's record of SmolLM-135M
   train 16 × 2,048 (phase 11's shape) and of Qwen3-8B prefill 4 × 512
   (phase 10's) on a 1 × 1 stand-in mesh, then their arguments made on the
   card, their bytes equal to the predicted ``argument_size_in_bytes``
   group by group; b. one real step's peak memory beside the predicted
   peak (the tolerance above ``PEAK_TOL_REL``; a miss is printed) and its
   time beside ``roofline_step_s`` and this script's own bound; c.
   ``dryrun_core``'s ``merge`` at one device's share (2^22 values) through
   ``distributed_histogram`` on an NCCL group of one rank, bit-equal to
   the world-1 composition run on the CPU, its time beside the predicted
   kernel bound; d. each example's ``main`` on the card at its smoke size,
   its printout held line by line to a run with ``device="cpu"``
   (``EXAMPLE_MODEL_TOL``, ``DRAWN_ON_DEVICE``), and the quickstart's row sorts, merge and
   bucket count at its shapes bit-equal to their plain versions;
7. the merge at every ``(Q, k, T+1, β)`` that ``merge_batched`` saw in
   phases 3–6 and 8–14, in each regime that holds it: device µs a call by
   item, wall µs and launches a call (the shapes also go to
   ``build/merge_shapes.json`` for ``scripts/merge_sweep.py``);
then the report: the kernels JSON line, throughput/latency, the card.

Phases 3, 5, 6, 8, 9, 10, 11, 12, 13 and 14 are the main paths: each is run with
the launch counts set to 0 just before it and read just after, and fails
unless every kernel of its path was launched (phase 9: the row sort, the
kv sort and the merge; phase 10: the row sort and the merge, counted over
``calibrate`` and the launcher; phase 11: the row sort and the merge,
counted over its two Trainers' 12 steps; phase 12: the row sort and the
merge, counted over DBRX's ``calibrate``; phase 13: the row sort and the
merge, counted over its three models' ``calibrate``; phase 14: the row sort
and the merge in the ``dryrun_core`` check, and the row sort, the merge and
the bucket count over the four examples); the run fails unless
each kernel was launched on them together (the kv sort only sorts merges
too long for one block: the log analytics path's T=2048 window merges and
phase 9's merges of many summaries).

The last line of standard output is ``{"ok": true, "device": {...}}``.
Writes nothing outside ``build/`` (the kernel build, the merge shapes,
phase 8's and phase 10's service directories, phase 9's rendezvous and
phase 11's checkpoints, removed at their ends).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
try:  # the card's figures and each kernel's bytes and operations: one copy, in the port
    from repro_torch.kernels.cost import (
        F32_FLOPS,
        HBM_BW,
        PEAK_FLOPS,
        bound_s,
        bucket_count_cost,
        decode_attention_cost,
        kv_sort_cost,
        merge_bytes,
        merge_cost,
        row_sort_cost,
    )
except ImportError as e:
    print(f"chip_smoke: the port is not importable beside this script: {e}", file=sys.stderr)
    sys.exit(2)
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
    """Least time for the work, ms: bytes over the memory rate or operations
    over the float32 rate, whichever is larger (``kernels.cost.bound_s``)."""
    t, by = bound_s(nbytes, ops)
    return t * 1e3, by


# the runtime and driver calls that start device work: a trace keeps one
# device record of each, under the call's correlation id
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def lost_launches(prof) -> int:
    """Launches in a trace with no device record.  A trace opened after a
    stretch without one can drop the records of kernels that started on an
    idle card; a short trace just before it makes that rare, and this count
    shows where it still happened."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events if e.device_type() == cuda}
    return sum(1 for e in events if e.device_type() != cuda and e.name().startswith(LAUNCH_APIS)
               and e.correlation_id() not in recorded)


def traced(fn, reps: int = 1, retries: int = 0):
    """``reps`` calls of ``fn`` under ``torch.profiler`` (CPU and CUDA),
    after a throwaway trace of a few small kernels; traced again, up to
    ``retries`` times, while the trace lost launches.  Returns the
    profile, the wall seconds of the calls, their device ms between CUDA
    events, the launches the trace lost and the traces made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for tries in range(1, retries + 2):
        torch.cuda.synchronize()
        with profile(activities=activities):
            w = torch.zeros(1024, device="cuda")
            for _ in range(8):
                w.add_(1)
            torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lost = lost_launches(prof)
        if not lost:
            break
    return prof, wall, start.elapsed_time(end), lost, tries


def device_items(prof) -> tuple[dict, int]:
    """Device µs by kernel or copy name in a trace, and their launches."""
    import torch

    items, ops = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            if t > 0:
                items[e.key] = items.get(e.key, 0.0) + t
                ops += e.count
    return items, ops


def device_breakdown(fn, retries: int = 0) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time, device kernel time by
    name (top 6), the device's idle share of the wall time, the CUDA
    events' ms around the same call and the launches the trace lost
    (``retries``: trace again while it lost some; for a ``fn`` that can run
    more than once)."""
    prof, wall, events, lost, _ = traced(fn, retries=retries)
    items, _ = device_items(prof)
    kern = {k: t / 1e3 for k, t in items.items()}
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    kinds = {}
    for k, t in kern.items():
        kinds[kernel_kind(k)] = kinds.get(kernel_kind(k), 0.0) + t
    return {
        "wall_ms": wall * 1e3,
        "events_ms": events,
        "lost_launches": lost,
        "device_ms": busy,
        "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
        "top_kernels_ms": {k[:60]: v for k, v in top},
        "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
    }


# kernel-name fragments by kind, first match wins (cuBLAS, cuDNN and PyTorch's own kernels)
KERNEL_KINDS = (
    ("copy", ("Memcpy", "Memset")),
    ("port kernel", ("onesweep", "histogram_kernel", "digit_scan", "resident_", "merge_kernel", "gather_cuts",
                     "count_kernel")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "gemv", "Kernel2")),
    ("conv", ("conv",)),
    ("softmax", ("softmax", "Softmax")),
    ("reduce", ("reduce", "Reduce")),
    ("sort / scan", ("sort", "Sort", "scan", "Scan")),
    ("index / gather", ("index", "gather", "scatter", "Index", "Gather", "Scatter")),
    ("cat", ("CatArray", "cat_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_kind(name: str) -> str:
    for kind, parts in KERNEL_KINDS:
        if any(part in name for part in parts):
            return kind
    return "other"


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


def summary_inputs(rng, Q: int, k: int, lo: int, hi: int, ties: bool, device, T: int = T):
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


def check_bucket_count(dev) -> int:
    """The bucket count against its plain version on the card, bit-equal,
    at its edge cases: ties, NaN/±inf/±0 values, b_T = +inf, int32 above
    2^24, NaN boundaries, T+1 in {2, 33, 255, 2049}, one T+1 that needs
    more than 48 KB of shared memory, the largest that fits it
    (``bucket_count.SHARED_MAX_T1``) and the next, and two wider (one and
    three passes over the slots), n in {0, 1, 3, 4, 5, 17, 5000, 2^20 + 3};
    searched prefixes at the edges of the BFS table's depth (m in {0 (all
    NaN), 1, 2^k - 1, 2^k, 2^k + 1} for k = 5, 8, 11); views of the stream
    at offsets of 1, 2 and 3 floats; a stream of one value, one of b_T only
    and a sorted one; one launch a call; and the rejection of unsorted
    boundaries.  Returns the number of cases."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import bucket_count, ref

    rng = np.random.default_rng(SEED + 2)
    cases = []  # (name, values, boundaries, offset of the view in floats)
    for m in (0, 1, 31, 32, 33, 255, 256, 257, 2047, 2048, 2049):
        x = np.round(rng.normal(size=(1 << 16) + 1) * 4).astype(np.float32)
        x[:4] = [np.nan, np.inf, -np.inf, -0.0]
        b = np.sort(np.round(rng.normal(size=m) * 4)).astype(np.float32)
        for pad in sorted({max(2 - m, 0), 3}):
            cases.append((f"m={m} + {pad} NaN", x, np.concatenate([b, [np.nan] * pad]).astype(np.float32), 0))
    b33 = np.sort(rng.normal(size=33)).astype(np.float32)
    for off in (0, 1, 2, 3):
        for n in (3, 4, 5, 17, (1 << 20) + 1):
            cases.append((f"n={n} at offset {off}", rng.normal(size=n).astype(np.float32), b33, off))
    b255 = np.sort(np.round(rng.normal(size=255) * 8)).astype(np.float32)
    cases += [
        ("one value", np.full((1 << 20) + 3, b255[100], np.float32), b255, 0),
        ("b_T only", np.full((1 << 20) + 3, b255[-1], np.float32), b255, 1),
        ("sorted", np.sort(rng.normal(size=(1 << 20) + 3).astype(np.float32) * 8), b255, 0),
    ]
    for T1 in (2, 33, 255, 2049):
        for n in (0, 1, 5000, (1 << 20) + 3):
            x = np.round(rng.normal(size=n) * 4).astype(np.float32)
            b = np.sort(np.round(rng.normal(size=T1) * 4)).astype(np.float32)  # ties
            cases.append((f"T+1={T1} n={n}", x, b, 0))
    x = rng.normal(size=1 << 20).astype(np.float32)
    at = rng.integers(0, x.size, 1 << 16)
    x[at] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32), at.size)
    b = np.sort(np.concatenate([rng.normal(size=250), [-0.0, 0.0, 0.0, -0.0, 0.0]])).astype(np.float32)
    cases += [
        ("NaN/inf/±0 values", x, b, 0),
        ("b_T = +inf", x, np.concatenate([b[:-1], [np.inf]]).astype(np.float32), 0),
        ("b_0 = -inf", x, np.concatenate([[-np.inf], b[1:]]).astype(np.float32), 0),
        ("NaN boundaries", x, np.concatenate([b[:200], [np.nan] * 55]).astype(np.float32), 0),
        ("int32 above 2^24", rng.integers(2**24, 2**31 - 1, size=(1 << 20) + 3, dtype=np.int32),
         np.sort(rng.integers(2**24, 2**31 - 1, size=255)).astype(np.float32), 0),
        ("T+1=20001 (shared memory above 48 KB)", x, np.sort(rng.normal(size=20_001)).astype(np.float32), 0),
        ("T+1=40001 (global memory)", x, np.sort(rng.normal(size=40_001)).astype(np.float32), 0),
    ]
    for T1 in (bucket_count.SHARED_MAX_T1, bucket_count.SHARED_MAX_T1 + 1):  # the last shared, the first global
        b = np.sort(rng.normal(size=T1)).astype(np.float32)
        cases.append((f"T+1={T1} ({'shared' if T1 == bucket_count.SHARED_MAX_T1 else 'global'} memory)", x, b, 0))
    cases += [
        ("T+1=150001 (global memory, three passes)", x, np.sort(rng.normal(size=150_001)).astype(np.float32), 0),
    ]
    for name, xc, bc, off in cases:
        xd = torch.from_numpy(xc).to(dev)
        if off:  # the same values in a view that starts off floats into its storage
            xd = torch.cat([torch.zeros(off, dtype=xd.dtype, device=dev), xd])[off:]
        bd = torch.from_numpy(bc).to(dev)
        kernels.reset_launches()
        got = kernels.cumulative_counts(xd, bd)
        assert kernels.LAUNCHES["bucket_count"] == 1, name
        want = ref.cumulative_counts_ref(xd, bd)
        assert torch.equal(got, want), f"bucket count {name}: differs from the plain version"
        assert torch.equal(got.cpu(), ref.cumulative_counts_ref(xd.cpu(), bd.cpu())), f"bucket count {name} vs CPU"
        sizes = kernels.bucket_sizes(xd, bd)
        assert torch.equal(sizes, ref.bucket_sizes_from_cumulative(ref.counts_ref(xd, bd)).float()), name
    for bad in ([0.0, 2.0, 1.0], [0.0, float("nan"), 1.0]):
        try:
            kernels.cumulative_counts(torch.ones(8, device=dev), torch.tensor(bad, device=dev))
        except ValueError:
            continue
        raise AssertionError(f"bucket count took unsorted boundaries {bad}")
    return len(cases)


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
    b, by = bound_ms(*row_sort_cost(rows, n, T))
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
    b, by = bound_ms(*kv_sort_cost(Q, L))
    out["sort_kv"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
    log(f"kv sort 1000x65536: {ms:.3f} ms, plain {plain:.3f} ms, torch.sort {lib:.3f} ms, bound {b:.3f} ms")
    del keys, vals, ko, vo, rk, rv

    out.update(check_merge(dev, rng))
    log(f"bucket count: {check_bucket_count(dev)} cases bit-equal to the plain version")
    log(f"summarize_tiles: {check_tiles_nonfinite(dev)} streams with NaN/±inf/±0 bit-equal to the CPU run")
    return out


def check_tiles_nonfinite(dev) -> int:
    """The tile Summarizer (``ops.summarize_tiles``: one row-sort and one
    merge launch) over streams holding NaN, ±inf and ±0, on the card and
    on the CPU, from a sprinkle to a stream of nothing else: sizes
    bit-equal, boundaries equal in value with one NaN mask (NaN sort last
    as one key, so a tile holding NaN ends in NaN boundaries on both
    sides).  Their bits differ only where the row sort writes its one NaN
    (0x7FFFFFFF) for any NaN and +0 for -0 (``tile_sort.sort_rows``); the
    plain version keeps the input's bits.  Returns the number of
    streams."""
    import torch

    from repro_torch import kernels

    rng = np.random.default_rng(SEED + 17)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
    cases = 0
    for n, share in ((67_584, 0.001), (67_584, 0.05), (3 * 4096 + 517, 0.5), (2 * 4096, 1.0), (1, 1.0)):
        x = rng.lognormal(-1.8, 0.55, size=n).astype(np.float32)
        at = rng.random(n) < share
        x[at] = rng.choice(special, int(at.sum()))
        kernels.reset_launches()
        hg = kernels.summarize_tiles(torch.from_numpy(x).to(dev), tile_len=4096, T_tile=512, T_out=2048)
        got = kernels.reset_launches()
        assert got["tile_sort"] == 1 and got["merge_cut"] == 1, (n, share, got)
        hc = kernels.summarize_tiles(x, tile_len=4096, T_tile=512, T_out=2048, device="cpu")
        assert torch.equal(hg.sizes.cpu().view(torch.int32), hc.sizes.view(torch.int32)), (n, share)
        a, b = hg.boundaries.cpu(), hc.boundaries
        assert a.dtype == b.dtype and same_sorted(a, b), (n, share)
        differ = a.view(torch.int32) != b.view(torch.int32)
        canon = (torch.isnan(a) & torch.isnan(b)) | ((a == 0) & (b == 0))
        assert bool(canon[differ].all()), (n, share)
        cases += 1
    return cases


# the kernels every path with a bucket count launches; the kv sort runs only
# in a merge too long for one block, so it is held to the five main paths
# together (main)
PATH_KERNELS = ("tile_sort", "merge_cut", "bucket_count")
# the merge's own kernels in a trace (csrc/merge_cut.cu)
MERGE_KERNELS = ("resident_merge_kernel", "long_merge_kernel")


def merge_bits_equal(got, want) -> bool:
    """Equal dtypes and equal bits of boundaries and sizes (NaN, -0 too)."""
    import torch

    return all(a.dtype == w.dtype and torch.equal(a.view(torch.int32), w.view(torch.int32)) for a, w in zip(got, want))


def merge_bound_ms(Q: int, k: int, T1: int, beta: int) -> float:
    return bound_ms(merge_bytes(Q, k, T1, beta), 0)[0]


def merge_regimes(k: int, T1: int) -> list[str]:
    """The merge regimes that hold k summaries of T1 - 1 buckets, the one
    the wrapper picks first."""
    from repro_torch.kernels import merge_cut

    return ["resident", "long"] if merge_cut.plan(k, T1 - 1) else ["long"]


def merged(bnd, sz, beta: int, regime: str, name: str):
    """One merge call in ``regime``, its launches checked: one merge
    kernel, and the kv sort exactly when the regime is long."""
    from repro_torch import kernels

    kernels.reset_launches()
    out = kernels.merge_batched(bnd, sz, beta, regime=regime)
    got = kernels.reset_launches()
    assert got["merge_cut"] == 1 and got["sort_kv"] == (regime == "long"), (name, regime, got)
    return out


def check_merge(dev, rng) -> dict:
    """The merge against its plain version on the card, bit for bit, in
    every regime that holds each case (``regime="resident"`` where the
    problem fits, ``"long"`` on all), float32 and int32: pull-ups, paper
    and registry queries, ties, β = 1, β > k(T+1), a Q=1 call as
    ``summarize_tiles`` makes it, the resident capacity's edges, ±0/±inf/NaN
    boundaries, n = 0 problems and zero-mass pad rows; the golden cases;
    the query shape against the CPU.  Then the timed shape (Q=1000, k=32,
    T=2032, β=254): whole calls, the plain version, the bound, and the
    device time split into the kv sort and the merge's own kernel.
    Returns the kernels line's entries."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ref

    cases = [  # (name, Q, k, T, β, lo, hi, ties)
        ("pull-up Q=512 k=2 beta=2032", 512, 2, T, T, 200_000, 200_001, False),
        ("query Q=1000 k=32 beta=254", 1000, 32, T, BETA, 150_000, 250_000, False),
        ("ties Q=64 k=16 beta=254", 64, 16, T, BETA, T, 400_000, True),
        ("beta=1 Q=8 k=5", 8, 5, T, 1, T, 5000, False),
        ("registry query Q=1000 k=32 T=256 beta=64", 1000, 32, 256, 64, 256, 65_537, False),
        ("summarize_tiles Q=1 k=17 T=512 beta=2048", 1, 17, 512, 2048, 4096, 4097, False),
        ("beta > k(T+1) Q=16 k=2 T=3 beta=20", 16, 2, 3, 20, 3, 40, True),
        ("k(T+1)=16384 Q=4 k=64 T=255", 4, 64, 255, BETA, 255, 100_000, True),
        ("k(T+1)=16385 Q=4 k=5 T=3276", 4, 5, 3276, BETA, 3276, 100_000, True),
    ]
    inputs = {}
    for name, Q, k, Tc, beta, lo, hi, ties in cases:
        inputs[name] = (*summary_inputs(rng, Q, k, lo, hi, ties, dev, T=Tc), beta)
    # non-finite boundaries, n = 0 problems and zero-mass pad rows, on the ties case
    b, sz, beta = (x.clone() if torch.is_tensor(x) else x for x in inputs["ties Q=64 k=16 beta=254"])
    b[0, 0, -1], b[1, 1, 0], b[2, 2, 100:] = float("inf"), -float("inf"), float("nan")
    b[3, 0, :3] = torch.tensor([-0.0, 0.0, -0.0], device=dev)
    sz[4] = 0.0
    sz[5, 1:] = 0.0
    b[6, 8:] = b[6, 7, -1]
    sz[6, 8:] = 0.0
    inputs["±0/±inf/NaN, n=0, pad rows Q=64 k=16"] = (b, sz, beta)
    n_checked = 0
    for name, (bnd, sz, beta) in inputs.items():
        assert float(sz.sum(dim=(1, 2)).max()) < 2**24, name
        Q, k, T1 = bnd.shape
        variants = [bnd] + ([bnd.to(torch.int32)] if bool(torch.isfinite(bnd).all()) else [])
        for bv in variants:
            want = ref.merge_ref(bv, sz, beta)
            for regime in merge_regimes(k, T1):
                assert merge_bits_equal(merged(bv, sz, beta, regime, name), want), f"merge {name} {regime} {bv.dtype}"
                n_checked += 1
        if name.startswith("query") or name.startswith("±0"):  # and against the CPU
            cb, cs = bnd[:64].contiguous(), sz[:64].contiguous()
            want = ref.merge_ref(cb.cpu(), cs.cpu(), beta)
            for regime in merge_regimes(k, T1):
                got = merged(cb, cs, beta, regime, name)
                assert merge_bits_equal(tuple(x.cpu() for x in got), want), f"merge {name} {regime} vs CPU"
    golden = merge_golden(dev)
    for name in ("pull-up Q=512 k=2 beta=2032", "registry query Q=1000 k=32 T=256 beta=64"):
        bnd, sz, beta = inputs[name]
        times = {r: cuda_ms(lambda: kernels.merge_batched(bnd, sz, beta, regime=r)) for r in ("resident", "long")}
        log(f"merge {name}: " + ", ".join(f"{r} {t:.4f} ms" for r, t in times.items())
            + f", bound {merge_bound_ms(*bnd.shape, beta):.4f} ms (bytes)")
    bnd_q, sz_q, beta_q = inputs["query Q=1000 k=32 beta=254"]
    rb, rs = kernels.merge_batched(bnd_q, sz_q, beta_q)
    wb, ws = ref.merge_ref(bnd_q, sz_q, beta_q)
    err = max(max_abs(rb, wb), max_abs(rs, ws))
    ms = cuda_ms(lambda: kernels.merge_batched(bnd_q, sz_q, beta_q))
    plain = cuda_ms(lambda: ref.merge_ref(bnd_q, sz_q, beta_q))
    Q, k, T1 = bnd_q.shape
    lreal = k * T1
    b, by = bound_ms(*merge_cost(Q, k, T1, beta_q))
    out = {"merge_cut": dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)}
    # the call's device time split into its kv sort and the merge's own kernel
    items = calls_breakdown(lambda: kernels.merge_batched(bnd_q, sz_q, beta_q), 5)["device_us_by_item"]
    own = sum(t for key, t in items.items() if any(m in key for m in MERGE_KERNELS))
    if own <= 0:
        raise RuntimeError(f"no merge kernel ({MERGE_KERNELS}) in the trace: {sorted(items)}")
    flat_keys = bnd_q.reshape(Q, lreal)  # what the long regime's kv sort orders, beside the library's stable sort
    out["merge_split"] = {
        "kv_sort_ms": (sum(items.values()) - own) / 1e3,
        "torch_sort_stable_ms": cuda_ms(lambda: torch.sort(flat_keys, dim=-1, stable=True)),
        "scan_and_cut_ms": own / 1e3,
        "kv_sort_bound_ms": bound_ms(kv_sort_cost(Q, lreal)[0], 0)[0],
        "scan_and_cut_bound_ms": bound_ms(12.0 * Q * lreal, 0)[0],
    }
    log(f"merge query split (device ms a call): {json.dumps(out['merge_split'])}")
    log(f"merge query 1000x32x2033 beta=254: {ms:.3f} ms, plain {plain:.3f} ms, bound {b:.3f} ms; "
        f"{len(inputs)} cases, {n_checked} (case, dtype, regime) calls + {golden} golden x 2 regimes bit-equal")
    return out


class MergeShapes:
    """While active, records every ``(Q, k, T+1, β, dtype)`` that
    ``merge_batched`` is called with on the card, and how often: each
    module of the port that bound the wrapper by name gets a recording
    stand-in, and the wrapper back on exit."""

    def __init__(self):
        self.seen: dict[tuple, int] = {}

    def __enter__(self):
        from repro_torch.kernels import merge_cut

        self.orig = orig = merge_cut.merge_batched

        def record(bounds, sizes, beta, **kw):
            if bounds.device.type == "cuda":
                key = (*bounds.shape, int(beta), str(bounds.dtype).removeprefix("torch."))
                self.seen[key] = self.seen.get(key, 0) + 1
            return orig(bounds, sizes, beta, **kw)

        self.patched = [
            m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch") and getattr(m, "merge_batched", None) is orig
        ]
        for m in self.patched:
            m.merge_batched = record
        return self

    def __exit__(self, *exc):
        for m in self.patched:
            m.merge_batched = self.orig
        return False


def merge_shape_inputs(rng, Q: int, k: int, T1: int, dtype: str, dev):
    """Seeded inputs of one merge shape, total mass at most 2^24 a problem
    (float32 sums exact)."""
    import torch

    Tn = T1 - 1
    # n = Tn exactly where k·(Tn + 1) passes 2^24 (phase 9's 32,768 × 512)
    hi = max(Tn + 1, min(400_000, (1 << 24) // (k + 1)))
    b, s = summary_inputs(rng, Q, k, Tn, hi, False, dev, T=Tn)
    return (torch.round(b).to(torch.int32) if dtype == "int32" else b), s


def merge_shape_times(dev, seen: dict, regimes: bool = True) -> list[dict]:
    """Each merge shape the main path gave ``merge_batched``: seeded inputs
    held bit-equal to the plain version, then 20 back-to-back calls timed
    (``calls_breakdown``: device µs a call by item, wall µs) with their
    launches a call and the call's byte bound, in each regime that holds
    the shape (``regimes``
    False: the wrapper's own choice only, with no ``regime`` argument)."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    rng = np.random.default_rng(SEED + 16)
    rows = []
    for (Q, k, T1, beta, dtype), calls in sorted(seen.items()):
        b, s = merge_shape_inputs(rng, Q, k, T1, dtype, dev)
        want = ref.merge_ref(b, s, beta)
        for regime in merge_regimes(k, T1) if regimes else [None]:
            kw = {"regime": regime} if regime else {}
            call = lambda: kernels.merge_batched(b, s, beta, **kw)
            assert merge_bits_equal(call(), want), (Q, k, T1, beta, dtype, regime)
            kernels.reset_launches()
            row = {"Q": Q, "k": k, "T": T1 - 1, "beta": beta, "dtype": dtype, "calls_on_path": calls,
                   "regime": regime or "default", "bound_us": merge_bound_ms(Q, k, T1, beta) * 1e3,
                   **calls_breakdown(call, 20)}
            got = kernels.reset_launches()
            row["launches_per_call"] = {name: got[name] / row["calls"] for name in ("merge_cut", "sort_kv")}
            rows.append(row)
            log("merge shape " + json.dumps(row))
    return rows


def calls_breakdown(fn, reps: int = 100) -> dict:
    """``reps`` back-to-back calls of ``fn``: wall µs a call (host clock to
    a synchronise), and from a ``torch.profiler`` trace of another ``reps``
    calls (traced again while it lost launches), device µs a call by item,
    device operations a call, and the calls of ``fn`` made."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e6
    prof, _, _, lost, tries = traced(fn, reps, retries=2)
    raw, ops = device_items(prof)
    items = {}
    for key, t in raw.items():
        items[key[:50]] = items.get(key[:50], 0.0) + t / reps
    return {"wall_us": wall, "device_us": sum(items.values()), "device_ops": ops / reps,
            "device_us_by_item": items, "lost_launches": lost, "calls": 1 + reps * (1 + tries)}


def bucket_count_shapes(dev) -> list[dict]:
    """The bucket count at the main path's shapes: a log-analytics day
    (67,584 lognormal values against 2,049 boundaries), an 11-day window
    (743,424 against 255) and a registry window (16 × 65,536 against 65),
    each against boundaries at the stream's own quantiles.  Each is held to
    its plain version, then timed over 100 back-to-back ``counts`` calls
    (``calls_breakdown``) with its launches a call from the counter."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import bucket_count, ref

    rng = np.random.default_rng(SEED + 15)
    out = []
    for name, n, T1 in (("day", 67_584, 2049), ("window", 743_424, 255), ("registry", 16 * 65_536, 65)):
        x = torch.from_numpy(rng.lognormal(-1.8, 0.55, size=n).astype(np.float32)).to(dev)
        b = torch.sort(x).values[torch.linspace(0, n - 1, T1, device=dev).long()].contiguous()
        assert torch.equal(bucket_count.counts(x, b), ref.counts_ref(x, b)), name
        kernels.reset_launches()
        row = {"shape": name, "n": n, "T+1": T1, **calls_breakdown(lambda: bucket_count.counts(x, b))}
        row["launches_per_call"] = kernels.reset_launches()["bucket_count"] / row["calls"]
        out.append(row)
        log("bucket count shape " + json.dumps(row))
    return out


def decode_attention_shape(dev) -> dict:
    """The decode attention kernel at the served cell's shape (Qwen3-8B,
    104 rows, a bfloat16 cache of 1,152 positions, the token at 1,088):
    held to the plain body on the card (one bfloat16 ulp), then timed by
    CUDA events beside the plain body and its byte bound, and over 100
    back-to-back calls (``calls_breakdown``: wall and device µs a call).
    Each call reads 464 MB, over nine times the L2 cache, so every call
    finds the cache cold."""
    import torch

    from repro_torch.kernels import gqa_decode
    from repro_torch.models import common

    B, Smax, Hkv, G, hd, pos = 104, 1152, 8, 4, 128, 1088
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    q = torch.randn((B, 1, Hkv, G, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Smax, Hkv, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Smax, Hkv, hd), generator=g, device=dev).to(torch.bfloat16)
    got = gqa_decode.decode_attention(q, k, v, pos)
    want = common.plain_decode_attention(q, k, v, pos)
    diff = (got.float() - want.float()).abs()
    w = want.float()
    ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8))
    past_ulp = diff - ulp  # tests/test_torch_cuda.py's tolerance: one ulp + 1e-5
    worst = int(torch.argmax(past_ulp))
    assert float(past_ulp.max()) <= 1e-5, f"decode attention: {float(past_ulp.max())} past one bfloat16 ulp"
    ms = cuda_ms(lambda: gqa_decode.decode_attention(q, k, v, pos), reps=50)
    plain = cuda_ms(lambda: common.plain_decode_attention(q, k, v, pos))
    b, by = bound_ms(*decode_attention_cost(B, Hkv, G, hd, pos + 1, 2, 2))
    chunk, splits = gqa_decode.plan(B, Hkv, Smax, None, torch.cuda.get_device_properties(dev).multi_processor_count)
    calls = calls_breakdown(lambda: gqa_decode.decode_attention(q, k, v, pos))
    host = decode_host_us(dev)
    step = decode_step_copies(dev)
    out = dict(max_abs_err=float(diff.max()), max_past_one_ulp=float(past_ulp.max()),
               beyond_one_ulp=int((past_ulp > 0).sum()), worst=(float(w.view(-1)[worst]), float(diff.view(-1)[worst])),
               ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
               library_ms=None, shape=f"B {B}, Smax {Smax}, Hkv {Hkv}, G {G}, hd {hd}, bf16, position {pos}",
               chunk=chunk, splits=splits, wall_us=calls["wall_us"], device_us=calls["device_us"],
               device_ops=calls["device_ops"], device_us_by_item=calls["device_us_by_item"], host_us=host,
               decode_step=step)
    log(f"decode attention {out['shape']}: {ms:.4f} ms ({b / ms * 100:.1f} % of the byte bound {b:.4f} ms), "
        f"plain {plain:.3f} ms; {splits} splits of {chunk}; a call {calls['wall_us']:.1f} us wall, "
        f"{calls['device_us']:.1f} us device, {calls['device_ops']:.0f} device ops; max abs err "
        f"{out['max_abs_err']:.3g}, {out['beyond_one_ulp']} of {w.numel()} outputs past one ulp, worst {out['worst']}")
    log(f"decode attention host us a call (1 row, 64 positions): {json.dumps(host)}")
    log(f"decode step, Qwen3-8B at 2 layers, 104 rows at 1,088: {json.dumps(step)}")
    return out


def decode_host_us(dev, reps: int = 2000) -> dict:
    """Wall µs a call, kernel and plain body, at a shape whose device time
    is a few µs (1 row, 8 KV heads of 4 query heads, 64 bfloat16
    positions): the host's cost of a call, which bounds a decode step
    whose device work is short."""
    import torch

    from repro_torch.kernels import gqa_decode
    from repro_torch.models import common

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    q = torch.randn((1, 1, 8, 4, 128), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((1, 64, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    out = {}
    for name, fn in (("kernel", gqa_decode.decode_attention), ("plain", common.plain_decode_attention)):
        fn(q, k, k, 63)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(q, k, k, 63)
        torch.cuda.synchronize()
        out[f"{name}_us"] = (time.perf_counter() - t0) / reps * 1e6
    return out


def decode_step_copies(dev) -> dict:
    """One ``decode_step`` of Qwen3-8B at full width and 2 layers (an
    ``Engine``'s bfloat16 run weights, 104 rows, a random bfloat16 cache
    of 1,152 positions, the token at 1,088), traced with input shapes:
    its device ops by name, the decode attention kernel's launches, and
    every copy or cast whose input has a cache layer's shape (none
    expected: the kernel reads the cache in place)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_model
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_map

    B, Smax, pos = 104, 1152, 1088
    cfg = dataclasses.replace(get_config("qwen3-8b"), repeats=2)
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED + 32), device=dev)
        eng = Engine(cfg, params, ServeConfig(max_seq=Smax, max_new_tokens=1), device=dev)
        cache = tree_map(lambda t: t.normal_(), init_cache(cfg, B, Smax, torch.bfloat16, dev))
        tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, dtype=torch.int32)
        decode_step(cfg, eng._run, cache, tok, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            decode_step(cfg, eng._run, cache, tok, pos)
            torch.cuda.synchronize()
    layer = [B, Smax, cfg.num_kv_heads, cfg.head_dim]
    copies = [(e.key, e.input_shapes) for e in prof.key_averages(group_by_input_shape=True)
              if e.key in ("aten::_to_copy", "aten::copy_", "aten::clone", "aten::contiguous", "aten::to")
              and any(sorted(s) == sorted(layer) for s in e.input_shapes if isinstance(s, list))]
    items, ops = device_items(prof)
    kernel = sum(e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "decode_kernel" in e.key)
    del eng, params, cache
    torch.cuda.empty_cache()
    assert not copies, f"decode step copies a cache layer: {copies}"
    assert kernel == cfg.repeats * len(cfg.pattern), kernel
    top = sorted(items.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ops": ops, "decode_kernel_launches": kernel, "cache_copies": len(copies),
            "device_us": sum(items.values()), "top_us": [[k[:60], v] for k, v in top]}


def sort_sweep(dev) -> dict:
    """Times of the row sort and the kv sort: the crossover sweep over row
    lengths 2^12 .. 2^20 at 2^28 keys a shape (each regime that can hold
    the row, beside ``torch.sort``), then the main path's exact shapes,
    uniform and skewed.  Every timed call is first held to its plain
    version.  Returns the table; prints one line per shape."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ref, tile_sort

    total = 1 << 28
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    flat = torch.rand(total, generator=g, device=dev)
    pay = torch.arange(total, device=dev, dtype=torch.int32)
    sweep = []
    for lg in range(12, 21):
        width = 1 << lg
        x, v = flat.view(-1, width), pay.view(-1, width)
        row = {"width": width, "rows": total // width}
        for kv in (False, True):
            tag = "kv" if kv else "row"
            regimes = ["onesweep"]
            if width <= (tile_sort.KV_RESIDENT_LIMIT if kv else tile_sort.ROW_RESIDENT_LIMIT):
                regimes.insert(0, "resident")
            for regime in regimes:
                if kv:
                    ko, vo = kernels.sort_kv(x, v, regime=regime)
                    assert torch.equal(vo, ref.sort_kv_ref(x, v)[1]), (width, regime)
                    del ko, vo
                    row[f"{tag}_{regime}_ms"] = cuda_ms(lambda: kernels.sort_kv(x, v, regime=regime))
                else:
                    assert torch.equal(kernels.sort_rows(x, regime=regime), torch.sort(x, dim=-1).values), (width, regime)
                    row[f"{tag}_{regime}_ms"] = cuda_ms(lambda: kernels.sort_rows(x, regime=regime))
        row["row_torch_sort_ms"] = cuda_ms(lambda: torch.sort(x, dim=-1))
        row["kv_torch_sort_stable_ms"] = cuda_ms(lambda: torch.sort(x, dim=-1, stable=True))
        sweep.append(row)
        log("sort sweep " + json.dumps(row))
    del flat, pay, x, v

    shapes = []
    lognormal = lambda r, w: torch.exp(torch.randn((r, w), generator=g, device=dev) * 0.55 - 1.8)
    gumbel = lambda r, w: -torch.log(-torch.log(torch.rand((r, w), generator=g, device=dev)))
    ties = lambda r, w: torch.randint(-50, 50, (r, w), generator=g, device=dev, dtype=torch.int32)
    magnitude = lambda r, w: torch.randn((r, w), generator=g, device=dev).abs_()
    cases = [  # (name, kind, rows, width, maker)
        ("scale Summarizer 256x2^20 gumbel", "row", 256, 1 << 20, gumbel),
        ("paper Summarizer 31x2^18 gumbel", "row", 31, 1 << 18, gumbel),
        ("registry Summarizer 256x2^16 lognormal", "row", 256, 1 << 16, lognormal),
        ("tile Summarizer 17x4096 lognormal", "row", 17, 4096, lognormal),
        ("i32 ties 64x2^16", "row", 64, 1 << 16, ties),
        ("pull-up merge 512x4066 (L=4096)", "pairs", 512, 2 * (T + 1), gumbel),
        ("registry query merge 1000x8224 (L=16384)", "pairs", 1000, 32 * 257, lognormal),
        ("query merge 1000x65056 (L=65536)", "pairs", 1000, 32 * (T + 1), gumbel),
        ("kv i32 ties 64x2^16", "kv", 64, 1 << 16, ties),
        # phase 9's single rows: a device's shard, and the embedding's gradient leaf
        ("distributed shard 1x2^28 gumbel", "row", 1, 1 << 28, gumbel),
        ("embed gradient leaf 1x28311552 |normal|", "row", 1, 49_152 * 576, magnitude),
        # skew at the sweep's size: against its 2^16-wide uniform rows
        ("i32 ties 4096x2^16", "row", 4096, 1 << 16, ties),
        ("lognormal 4096x2^16", "row", 4096, 1 << 16, lognormal),
        ("kv i32 ties 4096x2^16", "kv", 4096, 1 << 16, ties),
    ]
    for name, kind, rows, width, make in cases:
        x = make(rows, width)
        if kind == "row":
            assert same_sorted(kernels.sort_rows(x), torch.sort(x, dim=-1).values), name
            ms = cuda_ms(lambda: kernels.sort_rows(x))
            lib = cuda_ms(lambda: torch.sort(x, dim=-1))
        elif kind == "pairs":
            L = 1 << (width - 1).bit_length()
            assert torch.equal(kernels.argsort_pairs(x, L), ref.argsort_pairs_ref(x, L)), name
            ms = cuda_ms(lambda: kernels.argsort_pairs(x, L))
            lib = cuda_ms(lambda: torch.sort(x, dim=-1, stable=True))
        else:
            v = torch.arange(x.numel(), device=dev, dtype=torch.int32).view(x.shape)
            assert torch.equal(kernels.sort_kv(x, v)[1], ref.sort_kv_ref(x, v)[1]), name
            ms = cuda_ms(lambda: kernels.sort_kv(x, v))
            lib = cuda_ms(lambda: torch.sort(x, dim=-1, stable=True))
        regime = "resident" if tile_sort.plan(width, kind != "row") else "onesweep"
        shapes.append({"shape": name, "regime": regime, "ms": ms, "torch_sort_ms": lib})
        log("sort shape " + json.dumps(shapes[-1]))
        del x
    return {"sweep": sweep, "shapes": shapes}


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
            hs.append(build_exact(v, Tg, device="cpu"))
        b = torch.stack([h.boundaries for h in hs])[None]
        s = torch.stack([h.sizes for h in hs])[None]
        rb, rs = ref.merge_ref(b, s, beta)
        for regime in merge_regimes(k, Tg + 1):
            bo, so = merge_batched(b.to(dev), s.to(dev), beta, regime=regime)
            assert torch.equal(bo.cpu(), rb) and torch.equal(so.cpu(), rs), f"golden {seed} {regime}"
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
    for name in ("tile_sort", "merge_cut"):  # the store's kernels (its merges fit one block)
        assert launches[name] > 0, f"main path never launched {name}: {launches}"
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
    bc, skew = scale_bucket_count(dev, data, ans[0][0].boundaries)
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
        "bucket_count": bc,
        "bucket_count_skew": skew,
    }
    log(f"scale: {days} x {n} values ingested in {t_ing:.3f} s; 1000 windows in {t_qm:.3f} s; "
        f"8 windows within eps (worst |true - N/beta| / eps = {worst:.4f})")
    return out


def scale_bucket_count(dev, data: np.ndarray, boundaries: np.ndarray) -> tuple[dict, dict]:
    """The bucket count at the scale shape: all ``data`` (365 × 2^20) against
    one answer's 255 boundaries, bit-equal to its plain version, its sizes
    equal to an exact sort count (total 3.8e8 > 2^24), and timed; then
    streams of one value and of b_T only at the same shape, each bit-equal
    and timed.  Returns the kernels line's entry and the skew times."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ref

    allv = torch.from_numpy(data).to(dev)
    bnd = torch.from_numpy(boundaries).to(dev)
    N, T1 = allv.numel(), bnd.numel()
    got = kernels.cumulative_counts(allv, bnd)
    want = ref.cumulative_counts_ref(allv, bnd)
    assert torch.equal(got, want), "bucket count at scale: differs from the plain version"
    sizes = kernels.bucket_sizes(allv, bnd)
    true = true_occupancy(allv.reshape(-1), bnd)
    assert np.array_equal(sizes.cpu().numpy().astype(np.float64), true), "bucket sizes at scale: not exact"
    inside = int(((allv >= bnd[0]) & (allv <= bnd[-1])).sum())  # the rest is in no bucket
    assert true.sum() == inside, (true.sum(), inside)
    # ms: CUDA events around whole calls, as every kernel of the line is
    # timed; beside it the device time of a call and of its kernel alone,
    # from a trace
    flat = allv.reshape(-1)
    call = lambda: kernels.cumulative_counts(allv, bnd)

    def timed(tag: str) -> dict:
        items = calls_breakdown(call, 5)["device_us_by_item"]
        kernel = sum(t for k, t in items.items() if "count_kernel" in k)
        return {f"{tag}_ms": cuda_ms(call), f"{tag}_device_ms": sum(items.values()) / 1e3,
                f"{tag}_kernel_device_ms": kernel / 1e3}

    skew = timed("spread")
    ms = skew["spread_ms"]
    plain = cuda_ms(lambda: ref.cumulative_counts_ref(allv, bnd))
    lib = cuda_ms(lambda: torch.bincount(torch.bucketize(flat, bnd, right=True), minlength=T1 + 1))
    b, by = bound_ms(*bucket_count_cost(N, T1))
    err = max_abs(got, want)
    log(f"bucket count {N} values x {T1} boundaries: {ms:.3f} ms a call (device {skew['spread_device_ms']:.3f}, "
        f"kernel {skew['spread_kernel_device_ms']:.3f}), plain {plain:.3f} ms, bucketize+bincount {lib:.3f} ms, "
        f"bound {b:.3f} ms ({by}); sizes equal a sort count")
    # skew at the same shape: one value inside the boundaries, then b_T only
    del got, want, sizes
    for name, value in (("one_value", bnd[T1 // 2]), ("b_T_only", bnd[-1])):
        allv.fill_(value)
        assert torch.equal(kernels.cumulative_counts(allv, bnd), ref.cumulative_counts_ref(allv, bnd)), name
        skew.update(timed(name))
    log(f"bucket count skew at {N} x {T1}: " + json.dumps(skew))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib), skew


# ----------------------------------------------------------------- phase 5


def window_bound(eps: float, day_eps) -> float:
    """Composed bound of a window answer over approximate day summaries:
    the store's ε plus, per day, twice the day's own bound (a range of a
    day's buckets is off by at most its two ends)."""
    return eps + 2.0 * float(sum(day_eps))


def log_analytics(dev) -> tuple[dict, dict]:
    """The tile Summarizer path of ``examples/log_analytics.py`` on the card.
    Returns the launch counts of the path and its measurements."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import HistogramStore
    from repro_torch.examples.log_analytics import synth_day

    T_OUT, T_TILE, TILE = 2048, 512, 4096
    rng = np.random.default_rng(0)
    days = {d: synth_day(rng, d) for d in range(31)}
    wins = [(lo, hi) for lo in range(31) for hi in range(lo, 31)]
    vd = {d: torch.from_numpy(v).to(dev) for d, v in days.items()}
    sync(dev)

    def run():
        store = HistogramStore(num_buckets=T_OUT, device=dev)
        summ = {}
        for d, v in days.items():
            summ[d] = kernels.summarize_tiles(v, tile_len=TILE, T_tile=T_TILE, T_out=T_OUT)
            store.ingest_summary(d, summ[d])
        ans = store.query_many(wins, BETA)
        day_true = {d: kernels.bucket_sizes(vd[d], summ[d].boundaries) for d in days}
        win_true = [
            kernels.bucket_sizes(torch.cat([vd[d] for d in range(lo, hi + 1)]), torch.from_numpy(h.boundaries).to(dev))
            for (lo, hi), (h, _) in zip(wins, ans)
        ]
        sync(dev)
        return summ, ans, day_true, win_true

    kernels.reset_launches()
    t0 = time.perf_counter()
    summ, ans, day_true, win_true = run()
    wall = time.perf_counter() - t0
    launches = kernels.reset_launches()
    for name in PATH_KERNELS:
        assert launches[name] > 0, f"log analytics path never launched {name}: {launches}"
    prof = device_breakdown(run)
    day_eps = {}
    worst_day = 0.0
    for d, v in days.items():
        hc = kernels.summarize_tiles(v, tile_len=TILE, T_tile=T_TILE, T_out=T_OUT, device="cpu")
        h = summ[d]
        assert torch.equal(h.boundaries.cpu(), hc.boundaries) and torch.equal(h.sizes.cpu(), hc.sizes), d
        n = v.size
        assert float(h.sizes.double().sum()) == n and bool(torch.isfinite(h.boundaries).all())
        true = day_true[d].cpu().numpy().astype(np.float64)
        assert np.array_equal(true, true_occupancy(vd[d], h.boundaries)), f"day {d}: bucket_sizes vs sort"
        day_eps[d] = 2.0 * n / T_TILE + 2.0 * -(-n // TILE)
        dev_max = float(np.abs(true - n / T_OUT).max())
        assert dev_max <= day_eps[d], (d, dev_max, day_eps[d])
        worst_day = max(worst_day, dev_max / day_eps[d])
    worst_win = 0.0
    for (lo, hi), (h, eps), true_t in zip(wins, ans, win_true):
        vals = torch.cat([vd[d] for d in range(lo, hi + 1)])
        n = vals.numel()
        true = true_t.cpu().numpy().astype(np.float64)
        assert np.array_equal(true, true_occupancy(vals, torch.from_numpy(h.boundaries).to(dev))), (lo, hi)
        assert true.sum() == n and float(h.sizes.astype(np.float64).sum()) == n
        bound = window_bound(eps, [day_eps[d] for d in range(lo, hi + 1)])
        dev_max = float(np.abs(true - n / BETA).max())
        assert dev_max <= bound, (lo, hi, dev_max, bound)
        worst_win = max(worst_win, dev_max / bound)
    out = {
        "records": int(sum(v.size for v in days.values())),
        "wall_s": wall,
        "worst_day_dev_over_bound": worst_day,
        "worst_window_dev_over_bound": worst_win,
        "traced": prof,
    }
    log(f"log analytics: 31 ragged days ({out['records']} records) summarized bit-equal to the CPU; "
        f"496 windows; every day and window within its bound (worst {worst_day:.4f} / {worst_win:.4f}); "
        f"wall {wall:.3f} s; launches {launches}")
    log(f"log analytics traced: {json.dumps(prof)}")
    return launches, out


# ----------------------------------------------------------------- phase 6


def registry(dev, tenants: int = 256, days: int = 31, n: int = 65_536) -> tuple[dict, dict]:
    """The multi-tenant serving plane at dashboard scale.  Returns the launch
    counts of the path and its measurements."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import TenantRegistry

    T_REG, B_REG = 256, 64
    rng = np.random.default_rng(SEED + 6)
    data = rng.standard_normal(size=(tenants, days, n), dtype=np.float32)
    data *= 0.55
    data -= 1.8
    np.exp(data, out=data)  # lognormal latencies
    names = [f"svc{t:03d}" for t in range(tenants)]
    refresh = [(name, 0, days - 1) for name in names]
    pick = rng.integers(0, tenants, size=1000)
    lo = rng.integers(0, days, size=1000)
    hi = np.minimum(days - 1, lo + rng.integers(0, days, size=1000))
    wins = [(names[t], int(a), int(b)) for t, a, b in zip(pick, lo, hi)]

    def ingest(device, count: int = tenants):
        reg = TenantRegistry(num_buckets=T_REG, shared_arena=True, device=device)
        for t, name in enumerate(names[:count]):
            for d in range(days):
                reg.ingest_async(name, d, data[t, d])
        reg.flush()
        return reg

    kernels.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    reg = ingest(dev)
    sync(dev)
    t_ing = time.perf_counter() - t0
    reg.merge_dispatches = 0
    reg.reset_host_row_copies()
    t0 = time.perf_counter()
    dash = reg.query_many(refresh, B_REG)
    t_dash = time.perf_counter() - t0
    assert reg.merge_dispatches == 1, reg.merge_dispatches
    assert reg.host_row_copies == 0, reg.host_row_copies
    t0 = time.perf_counter()
    ans = reg.query_many(wins, B_REG)
    t_win = time.perf_counter() - t0
    check = rng.choice(len(wins), size=32, replace=False)
    true = {}
    for i in check:
        name, a, b = wins[i]
        t = names.index(name)
        vals = torch.from_numpy(data[t, a : b + 1].reshape(-1)).to(dev)
        true[i] = (kernels.bucket_sizes(vals, torch.from_numpy(ans[i][0].boundaries).to(dev)), vals)
    sync(dev)
    launches = kernels.reset_launches()
    for kname in PATH_KERNELS:
        assert launches[kname] > 0, f"registry path never launched {kname}: {launches}"
    worst = 0.0
    for i, (sizes, vals) in true.items():
        (h, eps), N = ans[i], vals.numel()
        got = sizes.cpu().numpy().astype(np.float64)
        assert np.array_equal(got, true_occupancy(vals, torch.from_numpy(h.boundaries).to(dev))), wins[i]
        assert got.sum() == N and float(h.sizes.astype(np.float64).sum()) == N
        dev_max = float(np.abs(got - N / B_REG).max())
        assert dev_max <= eps, (wins[i], dev_max, eps)
        worst = max(worst, dev_max / eps)
    for (h, eps), (name, a, b) in zip(dash, refresh):
        assert h.boundaries.shape == (B_REG + 1,) and np.all(np.isfinite(h.boundaries)), name
        assert float(h.sizes.astype(np.float64).sum()) == days * n
    cpu = ingest("cpu", 8)
    first = set(names[:8])
    qs = [q for q in refresh + wins if q[0] in first]
    cpu_ans = cpu.query_many(qs, B_REG)
    mine = {q: a for q, a in zip(refresh + wins, dash + ans)}
    for q, (hc, ec) in zip(qs, cpu_ans):
        hg, eg = mine[q]
        assert np.array_equal(hg.boundaries, hc.boundaries) and np.array_equal(hg.sizes, hc.sizes), q
        assert eg == ec, q
    prof = {
        "ingest": device_breakdown(lambda: ingest(dev).close()),
        "query_many": device_breakdown(lambda: reg.query_many(wins, B_REG + 1)),
    }
    reg.close()
    cpu.close()
    out = {
        "tenants": tenants,
        "days": days,
        "values": int(data.size),
        "ingest_s": t_ing,
        "ingest_values_per_s": data.size / t_ing,
        "refresh_256_s": t_dash,
        "query_many_1000_s": t_win,
        "worst_dev_over_eps": worst,
        "cpu_checked_queries": len(qs),
        "traced": prof,
    }
    log(f"registry: {tenants} tenants x {days} days x {n} values ingested in {t_ing:.3f} s; refresh of "
        f"{len(refresh)} windows in one merge, 0 host row copies, {t_dash:.3f} s; 1000 windows in "
        f"{t_win:.3f} s; {len(qs)} answers of 8 tenants bit-equal to the CPU registry; 32 windows within "
        f"eps (worst {worst:.4f}); launches {launches}")
    log(f"registry traced: {json.dumps(prof)}")
    return launches, out


# ----------------------------------------------------------------- phase 8

SVC_T, SVC_BETA = 256, 64


def same_answer(a, b) -> bool:
    """Bit-equal histograms (or both empty) and equal ε."""
    (ha, ea), (hb, eb) = a, b
    if ha is None or hb is None:
        return ha is None and hb is None and ea == eb
    return (ha.boundaries.dtype == hb.boundaries.dtype and np.array_equal(ha.boundaries, hb.boundaries)
            and np.array_equal(ha.sizes, hb.sizes) and ea == eb)


def service_sequence(dev, names, data, root, wins, panels, n_subs: int, traced: bool = False) -> dict:
    """The serving plane's sequence on ``dev``: a ``HistogramService``
    primary shipping to a replica-role service, each metric of ``names``
    recording ``data[i, d]`` (windows 0..days-1; the last two windows of
    ``data`` are the two ticks'), the first metric through ``record``, the
    rest through ``record_async`` + ``flush``; the replica's ``sync`` and
    both services' ``query_many`` of ``wins``; ``n_subs`` subscriptions
    over ``panels`` and two ticks, each a new window recorded into every
    metric and pushed in ONE evaluation pass (the batch is recorded with
    the plane's stale-listener hook lifted, then one ``mark_stale`` of all
    metrics); a ``TelemetryHub`` dashboard of ``panels`` and a
    ``StragglerDetector`` over 8 hosts; then ``close()`` of the primary
    without a checkpoint, recovery from its WAL, a checkpoint, and
    ``promote`` of the replica fencing the recovered primary.  Holds every
    step to its contract and returns the answers, pushes, times and
    counts, with where each record path's time went (the WAL's fsync
    clock, and clocks around the shipper and the pool worker's apply;
    ``traced``: plus ``torch.profiler`` breakdowns of the 1,000-window
    query, the second tick's records and its push)."""
    from repro_torch import kernels
    from repro_torch.core import PrimaryFenced, TelemetryHub
    from repro_torch.core.telemetry import StragglerDetector
    from repro_torch.serve import HistogramService

    days, n = data.shape[1] - 2, data.shape[2]
    on_card = dev.type == "cuda"
    kw = dict(num_buckets=SVC_T, shared_arena=True, device=dev)
    pdir, sdir = os.path.join(root, "primary"), os.path.join(root, "standby")
    out, t = {"counts": {}, "traced": {}}, {}

    def clock(fn):
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - t0

    svc = HistogramService(pdir, replicate_to=[sdir], **kw)
    rep = HistogramService(sdir, role="replica", **kw)
    # where a record's time goes: the WAL's own fsync clock, and clocks
    # around the shipper (both ack paths call it) and the pool worker's
    # apply (summarize + pull-up; it overlaps the submits)
    acct = {"ship_s": 0.0, "worker_apply_s": 0.0}

    def clocked(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acct[key] += time.perf_counter() - t0
        return run

    pool = svc.registry._pool
    svc.replicator.ship = pool.on_durable = clocked("ship_s", svc.replicator.ship)
    pool.apply_batch = clocked("worker_apply_s", pool.apply_batch)

    def breakdown(fn):
        before = dict(acct, fsync_s=svc.wal_stats()["fsync_seconds_total"], batches=pool.batches)
        _, wall = clock(fn)
        after = dict(acct, fsync_s=svc.wal_stats()["fsync_seconds_total"], batches=pool.batches)
        return wall, {"wall_s": wall, **{k: after[k] - before[k] for k in after}}

    t["record_sync_s"], sync_parts = breakdown(lambda: [svc.record(names[0], d, data[0, d]) for d in range(days)])

    def record_async():
        for i in range(1, len(names)):
            for d in range(days):
                svc.record_async(names[i], d, data[i, d])
        svc.flush()

    t["record_async_s"], async_parts = breakdown(record_async)
    out["record_breakdown"] = {"sync": sync_parts, "async": async_parts}
    applied, t["sync_s"] = clock(rep.sync)
    assert applied == len(names) * days, (applied, len(names) * days)
    drift = rep.follower.drift_by_tenant()
    assert drift == {m: 0 for m in names}, drift
    prim, t["query_many_primary_s"] = clock(lambda: svc.query_many(wins, SVC_BETA))
    repl, t["query_many_replica_s"] = clock(lambda: rep.query_many(wins, SVC_BETA))
    for q, a, b in zip(wins, prim, repl):
        assert not getattr(a, "degraded", False) and not b.degraded, q
        assert a[0] is not None and same_answer(a, b), q
        assert a[0].boundaries.shape == (SVC_BETA + 1,) and np.all(np.isfinite(a[0].boundaries)), q
        assert float(a[0].sizes.astype(np.float64).sum()) == (q[2] - q[1] + 1) * n, q
    out["answers"] = dict(zip(wins, prim))
    if traced:
        out["traced"]["query_many"] = device_breakdown(lambda: svc.query_many(wins, SVC_BETA + 1))

    # -- standing queries: n_subs subscriptions over the panels, two ticks
    reg, plane = svc.registry, svc.subscriptions
    subs = [svc.subscribe(*panels[i % len(panels)], SVC_BETA) for i in range(n_subs)]
    d0 = reg.merge_dispatches
    plane.flush()  # initial answers: one pass
    assert reg.merge_dispatches - d0 == 1 and all(len(s.drain()) == 1 for s in subs)

    def record_tick(day: int) -> None:
        reg._stale_listeners.remove(plane)  # the batch notifies once, below
        try:
            for i, m in enumerate(names):
                svc.record_async(m, day, data[i, day])
            svc.flush()
        finally:
            reg._stale_listeners.append(plane)

    def push():
        plane.mark_stale(names)
        plane.flush()

    def check_pushes(tag: str) -> list[float]:
        for m in names:
            reg[m]._tree._cache.clear()
        cold = dict(zip(panels, svc.query_many(panels, SVC_BETA)))  # cold pulls
        lags, last = [], {}
        for sub in subs:
            [up] = sub.drain()
            key = (up.tenant, up.lo, up.hi)
            assert not up.degraded and up.version == reg[up.tenant].version, (tag, key)
            assert same_answer((up.hist, up.eps), cold[key]), (tag, key)
            assert isinstance(up.hist.boundaries, np.ndarray), (tag, key)
            lags.append(up.lag_seconds)
            last[key] = (up.hist, up.eps)
        out["pushes"] = last
        return lags

    for tick, day in enumerate((days, days + 1)):
        if traced and tick == 1:
            out["traced"]["tick_records"] = device_breakdown(lambda: record_tick(day))
        else:
            record_tick(day)
        before, d0, b0 = dict(kernels.LAUNCHES), reg.merge_dispatches, plane.eval_batches
        if traced and tick == 1:
            out["traced"]["tick"] = device_breakdown(push)
            el = out["traced"]["tick"]["wall_ms"] / 1e3
        else:
            _, el = clock(push)
        got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        assert reg.merge_dispatches - d0 == 1 and plane.eval_batches - b0 == 1, (tick, reg.merge_dispatches - d0)
        if on_card:
            assert got["merge_cut"] == 1 and got["tile_sort"] == 0 and got["sort_kv"] == 0, (tick, got)
        lags = check_pushes(f"tick {tick}")
        if tick == 0:
            t["tick_mark_to_last_delivery_s"] = el
            out["push_lag_s"] = {"p50": float(np.percentile(lags, 50)), "p99": float(np.percentile(lags, 99)),
                                 "max": float(max(lags))}
            out["counts"]["tick_launches"] = got
    st = plane.stats()
    out["counts"].update(subscriptions=st["subscriptions"], windows=st["windows"],
                         updates_delivered=st["updates_delivered"], dedup_saved=st["dedup_saved"])

    # -- a dashboard of the same panels through the same registry, and stragglers
    hub = TelemetryHub(T=SVC_T, registry=reg)
    d0 = reg.merge_dispatches
    dash = hub.dashboard(panels, beta=SVC_BETA)  # the tick's evaluation cached these
    assert reg.merge_dispatches == d0
    assert all(same_answer(a, out["pushes"][p]) for p, a in zip(panels, dash))
    dash = hub.dashboard(panels, beta=SVC_BETA // 2)
    assert reg.merge_dispatches - d0 == 1
    for (m, lo, hi), (h, _) in zip(panels, dash):
        assert float(h.sizes.astype(np.float64).sum()) == (min(hi, days + 1) - lo + 1) * n, (m, lo, hi)
    out["dashboard"] = dict(zip(panels, dash))
    det = StragglerDetector(window=64, T=64, device=dev)
    srng = np.random.default_rng(SEED + 8)
    for _ in range(64):
        for host in range(8):
            det.record(host, (0.10 + 0.005 * srng.standard_normal()) * (3.0 if host == 5 else 1.0))
    out["straggler"] = det.flag()
    assert out["straggler"][0] == [5] and 0.1 < out["straggler"][1] < 0.35, out["straggler"]

    # -- crash, recovery and failover
    before = svc.query_many(wins + panels, SVC_BETA)
    shipped = svc.replicator.bytes_shipped
    out["counts"]["wal_bytes"] = svc.wal_stats()["bytes_written"]
    svc.close()  # no checkpoint: the WAL holds everything
    svc.registry._wal.close()
    svc2, t["recover_s"] = clock(lambda: HistogramService(pdir, replicate_to=[sdir], **kw))
    assert svc2.recovery["replayed"] == len(names) * (days + 2), svc2.recovery
    after = svc2.query_many(wins + panels, SVC_BETA)
    assert all(same_answer(a, b) and not getattr(b, "degraded", False) for a, b in zip(before, after))
    _, t["checkpoint_s"] = clock(svc2.checkpoint)
    rep.sync()
    _, t["promote_s"] = clock(lambda: rep.promote(fence=svc2.replicator.fence))
    promoted = rep.query_many(wins + panels, SVC_BETA)
    assert all(same_answer(a, b) and not getattr(b, "degraded", False) for a, b in zip(before, promoted))
    rep.record(names[0], days + 2, data[0, 0])  # the promoted service takes writes
    try:
        svc2.record(names[0], days + 3, data[0, 1])
        raise AssertionError("the deposed primary took an append")
    except PrimaryFenced:
        pass
    out["recovered"] = dict(zip(wins + panels, after))
    out["counts"]["shipped_bytes"] = shipped + svc2.replicator.bytes_shipped
    out["counts"]["recovery"] = svc2.recovery
    for s in (rep, svc2):
        s.close()
    svc2.registry._wal.close()
    rep.registry._wal.close()
    values = len(names) * days * n
    out["times"] = t
    out["record_sync_values_per_s"] = days * n / t["record_sync_s"]
    out["record_async_values_per_s"] = (values - days * n) / t["record_async_s"]
    return out


def service(dev, metrics: int = 64, days: int = 31, n: int = 65_536, n_subs: int = 10_000,
            cpu_metrics: int = 4) -> tuple[dict, dict]:
    """The serving plane at a metrics sidecar's state size: 64 metrics ×
    31 daily windows × 65,536 lognormal values through ``HistogramService``
    (``service_sequence``), 1,000 random windows, 10,000 subscriptions over
    256 distinct windows (4 a metric: all time, the last 8 days, one random
    span, one day); then the same sequence on the CPU for the first
    ``cpu_metrics`` metrics, its answers, pushes, dashboard, recovered
    answers and straggler cut held bit-equal to the card's.  Returns the
    launch counts of the card's sequence and its measurements."""
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels

    rng = np.random.default_rng(SEED + 7)
    data = rng.standard_normal(size=(metrics, days + 2, n), dtype=np.float32)
    data *= 0.55
    data -= 1.8
    np.exp(data, out=data)  # lognormal latencies
    names = [f"svc{m:02d}.latency_ms" for m in range(metrics)]
    pick = rng.integers(0, metrics, size=1000)
    lo = rng.integers(0, days, size=1000)
    hi = np.minimum(days - 1, lo + rng.integers(0, days, size=1000))
    wins = [(names[m], int(a), int(b)) for m, a, b in zip(pick, lo, hi)]
    panels = []
    for m in names:
        mine = {(m, 0, days + 1), (m, days - 7, days + 1)}
        while len(mine) < 4:
            a = int(rng.integers(0, days))
            mine.add((m, a, a if len(mine) == 3 else int(rng.integers(a, days))))
        panels += sorted(mine)
    assert len(set(panels)) == 4 * metrics
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="service-", dir=os.path.join(ROOT, "build"))
    try:
        kernels.reset_launches()
        card = service_sequence(dev, names, data, os.path.join(root, "card"), wins, panels, n_subs, traced=True)
        launches = kernels.reset_launches()
        for name in ("tile_sort", "merge_cut"):
            assert launches[name] > 0, f"service path never launched {name}: {launches}"
        first = set(names[:cpu_metrics])
        cpu = service_sequence(
            torch.device("cpu"), names[:cpu_metrics], data[:cpu_metrics], os.path.join(root, "cpu"),
            [q for q in wins if q[0] in first], [p for p in panels if p[0] in first], 4 * cpu_metrics,
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checked = 0
    for part in ("answers", "pushes", "dashboard", "recovered"):
        for q, a in cpu[part].items():
            assert same_answer(card[part][q], a), (part, q)
            checked += 1
    assert card["straggler"][0] == cpu["straggler"][0] and card["straggler"][1] == cpu["straggler"][1]
    card["cpu_checked_answers"] = checked
    res = {k: v for k, v in card.items() if k not in ("answers", "pushes", "dashboard", "recovered")}
    res.update(metrics=metrics, days=days, values=metrics * days * n, subscriptions=n_subs,
               straggler=[card["straggler"][0], card["straggler"][1]])
    t = card["times"]
    log(f"service: {metrics} metrics x {days} days x {n} values; record sync {res['record_sync_values_per_s']:.4g} "
        f"values/s, async+flush {res['record_async_values_per_s']:.4g} values/s; replica sync {t['sync_s']:.3f} s; "
        f"query_many 1000 primary {t['query_many_primary_s']:.4f} s, replica {t['query_many_replica_s']:.4f} s "
        f"(bit-equal, zero drift); {n_subs} subscriptions over {len(panels)} windows, tick: 1 merge dispatch, "
        f"launches {card['counts']['tick_launches']}, mark to last delivery {t['tick_mark_to_last_delivery_s']:.4f} s, "
        f"push lag p50 {card['push_lag_s']['p50']:.4f} s p99 {card['push_lag_s']['p99']:.4f} s; straggler "
        f"{card['straggler'][0]}; recovery {t['recover_s']:.3f} s, promote {t['promote_s']:.3f} s; WAL "
        f"{card['counts']['wal_bytes']} bytes, shipped {card['counts']['shipped_bytes']} bytes; {checked} answers of "
        f"{cpu_metrics} metrics bit-equal to the CPU run; launches {launches}")
    log(f"service record breakdown (s): {json.dumps(card['record_breakdown'])}")
    log(f"service traced: {json.dumps(card['traced'])}")
    return launches, res


# ----------------------------------------------------------------- phase 9

# SmolLM-135M's parameter shapes (src/repro/configs/smollm_135m.py: 30
# layers, d_model 576, 9 heads × 64, 3 kv heads, d_ff 1,536, vocab 49,152,
# tied embeddings), written out here: the gradient tree of phase 9
SMOLLM_135M = {"layers": 30, "d_model": 576, "heads": 9, "kv_heads": 3, "head_dim": 64,
               "d_ff": 1536, "vocab": 49_152}


def smollm_grad_shapes() -> dict[str, tuple[int, ...]]:
    """``named_parameters()``-style names and shapes: 272 leaves, 134.5 M
    values."""
    c = SMOLLM_135M
    d, q, kv, ff = c["d_model"], c["heads"] * c["head_dim"], c["kv_heads"] * c["head_dim"], c["d_ff"]
    shapes = {"embed.weight": (c["vocab"], d)}
    for i in range(c["layers"]):
        p = f"layers.{i}."
        shapes.update({
            p + "attn_norm.weight": (d,), p + "attn.wq": (d, q), p + "attn.wk": (d, kv),
            p + "attn.wv": (d, kv), p + "attn.wo": (q, d), p + "mlp_norm.weight": (d,),
            p + "mlp.gate": (d, ff), p + "mlp.up": (d, ff), p + "mlp.down": (ff, d),
        })
    shapes["final_norm.weight"] = (d,)
    return shapes


def seeded_tree(dev, shapes: dict, seed: int) -> dict:
    """Normal values on the card with a per-leaf scale, from ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(s, generator=g, device=dev) * float(10.0 ** rng.uniform(-4, -1))
            for k, s in shapes.items()}


def event_call(fn):
    """``(fn(), device ms between CUDA events around it, wall ms)``."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def world_1(h, beta: int):
    """What a mesh of one rank gives ``gather_and_merge``: the merge of the
    one summary (the all-gather of one rank is the identity)."""
    from repro_torch.core import Histogram, merge

    return merge(Histogram(h.boundaries[None], h.sizes[None]), beta)


def same_hist(a, b) -> bool:
    import torch

    return torch.equal(a.boundaries.cpu(), b.boundaries.cpu()) and torch.equal(a.sizes.cpu(), b.sizes.cpu())


def rank_window(leaves, thr) -> tuple[int, int]:
    """Exact ``#(|g| < thr)`` and ``#(|g| <= thr)`` over the leaves."""
    import torch

    lt = sum(int(torch.sum(torch.abs(g) < thr)) for g in leaves)
    le = sum(int(torch.sum(torch.abs(g) <= thr)) for g in leaves)
    return lt, le


def distributed_plane(dev, n_log2: int = 28, n_small_log2: int = 22) -> tuple[dict, dict]:
    """The distributed Summarizer → Merger and the gradient-quantile plane
    on an NCCL group of one rank (``FileStore`` rendezvous in ``build/``):

    a. ``distributed_histogram`` of 2^28 seeded Gumbel values (1 GiB, a
       device's data shard), T = 4096, β = 254, on a ``("data",)`` mesh;
    b. the same values through ``distributed_histogram_hierarchical`` on a
       ``(1, 1)`` ``("pod", "data")`` mesh at its defaults;
    c. a and b at 2^22 values, then their CPU runs;
    d. a SmolLM-135M gradient tree (272 leaves): ``grad_quantile``,
       quantile ``clip_grads`` + one ``adamw_update``, ``compress_grads``,
       each without a mesh and with the one-rank mesh;
    e. ``LengthBucketer(8, 256).fit`` of 64 shards × 2^20 document lengths.

    The launch counts are read right after those calls; then the checks
    (the Summarizers of a and of every gradient leaf equal to ``torch.sort``
    at their cuts; a, b: true occupancy from ``torch.sort`` within the
    composed bounds; c, e: bit-equal to the CPU; d: rank error within 2N/T
    of an exact count, sparse + residual equal to the gradient) and the
    device-level merge of b timed, split into its kv sort and its scan and
    cut.  Returns the launch counts and the measurements."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.core import (
        build_exact_batched, distributed_histogram, distributed_histogram_hierarchical,
        hierarchical_device_summary, hierarchical_eps_bound, local_summarize, theoretical_eps_max,
    )
    from repro_torch.core.telemetry import grad_quantile, tree_summaries
    from repro_torch.data import LengthBucketer, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import (
        CompressionConfig, OptimizerConfig, adamw_update, clip_grads, compress_grads, init_opt_state,
        init_residual,
    )

    T_a, tile, T_tile, T_dev, T_pod = 4096, 8192, 512, 4096, 4096  # b: the module's defaults
    N, n_small = 1 << n_log2, 1 << n_small_log2
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = -torch.log(torch.empty(N, device=dev).exponential_(generator=g).clamp_(min=torch.finfo(torch.float32).tiny))
    shapes = smollm_grad_shapes()
    grads = seeded_tree(dev, shapes, SEED + 10)
    params = seeded_tree(dev, shapes, SEED + 11)
    n_grad = sum(v.numel() for v in grads.values())
    data = SyntheticLM(vocab_size=SMOLLM_135M["vocab"], seq_len=2048, global_batch=1, seed=SEED)
    rng = np.random.default_rng(SEED + 12)
    shards = [data.doc_lengths(rng, 1 << 20) for _ in range(64)]
    cfg = OptimizerConfig(clip_mode="quantile", clip_q=0.999, clip_hist_T=512)
    ccfg = CompressionConfig(enabled=True, rho=0.01, hist_T=1024)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="nccl-", dir=os.path.join(ROOT, "build"))
    torch.cuda.set_device(dev)
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0, world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        mesh, pods = make_mesh((1,), ("data",)), make_mesh((1, 1), ("pod", "data"))
        ms, wall = {}, {}

        def call(name, fn):
            out, ms[name], wall[name] = event_call(fn)
            return out

        t0 = time.perf_counter()  # NCCL makes its communicators at the first collective
        for m in (mesh, pods):
            for ax in m.mesh_dim_names:
                dist.all_gather([torch.empty(1, device=dev)], torch.zeros(1, device=dev), group=m.get_group(ax))
        torch.cuda.synchronize()
        nccl_init_ms = (time.perf_counter() - t0) * 1e3
        kernels.reset_launches()
        big, small = f"2^{n_log2}", f"2^{n_small_log2}"
        h_a = call(f"a distributed_histogram {big}", lambda: distributed_histogram(x, T_a, BETA, mesh))
        h_b = call(f"b hierarchical {big}", lambda: distributed_histogram_hierarchical(x, pods))
        xs = x[:n_small]
        s_a = call(f"c distributed_histogram {small}", lambda: distributed_histogram(xs, T_a, BETA, mesh))
        s_b = call(f"c hierarchical {small}", lambda: distributed_histogram_hierarchical(xs, pods))
        thr = {}
        for tag, kw in (("no mesh", {}), ("mesh", {"mesh": mesh, "axis_names": ("data",)})):
            thr[tag] = call(f"d grad_quantile {tag}", lambda: grad_quantile(grads, 0.999, 512, **kw))
            clipped, cm = call(f"d clip_grads {tag}", lambda: clip_grads(grads, cfg, **kw))
            state = init_opt_state(params, cfg)
            new_p, new_s, _ = call(f"d adamw_update {tag}", lambda: adamw_update(clipped, state, params, cfg))
            resid = init_residual(grads)
            sparse, new_r, km = call(f"d compress_grads {tag}", lambda: compress_grads(grads, resid, ccfg, **kw))
            thr[tag + " clip"], thr[tag + " compress"], thr[tag + " kept"] = (
                cm["clip_threshold"], km["compress_threshold"], km["compress_kept_fraction"])
            assert torch.equal(thr[tag + " clip"], thr[tag])
            for k, v in clipped.items():
                assert bool(torch.all(torch.abs(v) <= thr[tag])), k
            for k in grads:  # error feedback is lossless, bit for bit
                assert torch.equal(sparse[k] + new_r[k], grads[k]), k
                assert bool(torch.isfinite(new_p[k]).all()) and not torch.equal(new_p[k], params[k]), k
            assert int(new_s["step"]) == 1
            del clipped, state, new_p, new_s, resid, sparse, new_r
        fit = call("e LengthBucketer.fit 64 x 2^20", lambda: LengthBucketer(8, 256, device=dev).fit(shards))
        launches = kernels.reset_launches()
        path_s = time.perf_counter() - t_phase
        for name in ("tile_sort", "sort_kv", "merge_cut"):
            assert launches[name] > 0, f"distributed path never launched {name}: {launches}"

        # the path's row sorts at its own shapes: each Summarizer's boundaries
        # are the sorted values at the masked cuts (no sums: exact at any n)
        def at_cuts(v, T_):
            n = v.shape[0]
            cuts = torch.minimum(torch.as_tensor(ref.masked_cuts([n], T_))[0], torch.tensor(n - 1))
            return v[cuts.to(v.device)]

        v = torch.sort(x).values
        assert same_sorted(local_summarize(x, T_a).boundaries, at_cuts(v, T_a)), "a's Summarizer"
        for key, h in tree_summaries(grads, 512).items():
            leaf = next(g for name, g in grads.items() if key == f"['{name}']")
            want = at_cuts(torch.sort(torch.abs(leaf).reshape(-1)).values, min(512, leaf.numel()))
            assert same_sorted(h.boundaries, want), f"gradient leaf {key}'s Summarizer"
        res = {}
        n_tiles = N // tile
        bounds = {
            "a": theoretical_eps_max(N, T_a, k=1, exact_inputs=False),
            "b": hierarchical_eps_bound(N, (T_tile, T_dev, T_pod), (n_tiles, 1, 1)),
        }
        for tag, h in (("a", h_a), ("b", h_b)):
            b = h.boundaries
            assert b.shape == (BETA + 1,) and bool(torch.isfinite(b).all()), tag
            lo, hi = torch.searchsorted(v, b[:-1]), torch.searchsorted(v, b[1:])
            true = (hi - lo).double()
            true[-1] += float((v == b[-1]).sum())
            assert float(true.sum()) == N, tag
            err = float((true - N / BETA).abs().max())
            rep = float((h.sizes.double() - N / BETA).abs().max())
            assert err <= bounds[tag] and rep <= bounds[tag], (tag, err, rep, bounds[tag])
            res[tag] = {"true_err": err, "reported_err": rep, "bound": bounds[tag],
                        "sizes_sum": float(h.sizes.double().sum())}
        assert res["a"]["sizes_sum"] == N
        del v
        # c: the 2^22 runs bit-equal to the world-1 composition on the CPU
        xc = xs.cpu()
        cpu_a = world_1(local_summarize(xc, T_a), BETA)
        cpu_b = world_1(world_1(hierarchical_device_summary(xc, tile, T_tile, T_dev), T_pod), BETA)
        assert same_hist(s_a, cpu_a) and same_hist(s_b, cpu_b)
        assert float(s_a.sizes.double().sum()) == n_small == float(s_b.sizes.double().sum())
        # d: the thresholds' rank error against an exact count
        T_gq = 512
        for tag in ("no mesh", "mesh"):
            for key, q, Tq in ((tag, 0.999, T_gq), (tag + " compress", 1 - ccfg.rho, ccfg.hist_T)):
                lt, le = rank_window(grads.values(), thr[key])
                target = q * n_grad
                off = max(0.0, lt - target, target - le)
                assert off <= 2 * n_grad / Tq, (key, lt, le, target)
                res[f"rank_off {key}"] = off / n_grad
            kept = float(thr[tag + " kept"])
            assert abs(kept - ccfg.rho) <= 2 / ccfg.hist_T, (tag, kept)
        # e: the bucketer bit-equal to a CPU fit
        cpu_fit = LengthBucketer(8, 256, device="cpu").fit(shards)
        assert fit.boundaries_.tobytes() == cpu_fit.boundaries_.tobytes()
        assert torch.equal(fit.merged_.sizes.cpu(), cpu_fit.merged_.sizes)

        # the all-gather of one summary's boundaries, and the device-level merge of b split
        b1 = h_a.boundaries.new_zeros((T_a + 1,))
        outs = [torch.empty_like(b1)]
        ag_ms = cuda_ms(lambda: dist.all_gather(outs, b1, group=mesh.get_group("data")), reps=100)
        head = x[: n_tiles * tile].reshape(n_tiles, tile)
        tiles = build_exact_batched(head, T_tile)
        bnd, sz = tiles.boundaries[None].contiguous(), tiles.sizes[None].contiguous()
        whole = cuda_ms(lambda: kernels.merge_batched(bnd, sz, T_dev), reps=5)
        items = calls_breakdown(lambda: kernels.merge_batched(bnd, sz, T_dev), 5)["device_us_by_item"]
        own = sum(t for key, t in items.items() if any(m in key for m in MERGE_KERNELS))
        if own <= 0:
            raise RuntimeError(f"no merge kernel ({MERGE_KERNELS}) in the trace: {sorted(items)}")
        pairs = n_tiles * (T_tile + 1)  # the bounds count these, not the kv sort's padding
        flat_keys = bnd.reshape(1, -1)
        res["device_merge_q1"] = {
            "shape": [1, n_tiles, T_tile + 1, T_dev], "pairs": pairs, "ms": whole,
            "kv_sort_ms": (sum(items.values()) - own) / 1e3, "scan_and_cut_ms": own / 1e3,
            "torch_sort_stable_ms": cuda_ms(lambda: torch.sort(flat_keys, dim=-1, stable=True), reps=5),
            "bound_ms": merge_bound_ms(1, n_tiles, T_tile + 1, T_dev),
            "kv_sort_bound_ms": bound_ms(kv_sort_cost(1, pairs)[0], 0)[0],
            "scan_and_cut_bound_ms": bound_ms(12.0 * pairs, 0)[0],
        }
        del head, tiles, bnd, sz
        res["traced"] = {
            f"a distributed_histogram {big}": device_breakdown(
                lambda: distributed_histogram(x, T_a, BETA, mesh), retries=2),
            f"b hierarchical {big}": device_breakdown(lambda: distributed_histogram_hierarchical(x, pods), retries=2),
            "d grad_quantile no mesh": device_breakdown(lambda: grad_quantile(grads, 0.999, 512), retries=2),
        }
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    res.update(call_ms=ms, call_wall_ms=wall, all_gather_ms=ag_ms, nccl_init_ms=nccl_init_ms,
               path_s=path_s, values=N,
               grad_leaves=len(shapes), grad_values=n_grad,
               thresholds={k: float(t) for k, t in thr.items()}, bucket_boundaries=fit.boundaries_.tolist())
    for name in ms:
        log(f"distributed call {name}: device {ms[name]:.3f} ms (CUDA events), wall {wall[name]:.3f} ms")
    log(f"distributed: NCCL communicators {nccl_init_ms:.1f} ms; all-gather of {T_a + 1} float32 on the "
        f"one-rank mesh {ag_ms:.4f} ms a call; device-level merge (Q=1) {json.dumps(res['device_merge_q1'])}")
    log(f"distributed: the Summarizers of a and of the {len(shapes)} gradient leaves equal to torch.sort at "
        f"their cuts; a/b within bounds ({json.dumps({k: res[k] for k in ('a', 'b')})}); 2^22 bit-equal to "
        f"the CPU; {len(shapes)} leaves, {n_grad} values, thresholds {json.dumps(res['thresholds'])}; "
        f"bucketer bit-equal to the CPU; launches {launches}; path {path_s:.1f} s")
    log(f"distributed traced: {json.dumps(res['traced'])}")
    return launches, res


# phase 10's tolerances, set from the dtypes before the first run:
# - float32 decode against prefill: the reference test's own (tests/test_models.py);
F32_STEP_TOL = 2e-3
# - float32 card against CPU at smoke width: reduction orders differ, ~1e-6 of
#   logits near 1 measured on the CPU against XLA; 100x that;
F32_TOL = 1e-4
# - bfloat16 against float32 (and bf16 decode against bf16 prefill): each
#   rounding to bf16 errs by up to 2^-9 relative; some 7 roundings a layer
#   over 36 layers add up as a random walk to sqrt(252) * 2^-9 ~ 3 % of the
#   residual stream, so rms(diff) <= 0.05 rms(f32 logits) and, over ~6e5
#   logits (5 sigma), max |diff| <= 0.25 rms(f32 logits).
BF16_RMS_TOL, BF16_MAX_TOL = 0.05, 0.25


def rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def frontend_inputs(cfg, B: int, rng) -> dict:
    """The frontend's inputs for B rows, float32 from ``rng``: whisper's
    frames ``(B, encoder_seq, d)``, pixtral's patch embeddings ``(B,
    frontend_tokens, d)``; none for a text-only config."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)
    return out


def stream_extra(batch: dict) -> int:
    """The stream positions a batch's patch embeddings add ahead of its tokens."""
    return batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0


def forced_greedy(cfg, params, prompts, want, max_seq: int, dev, margin: float) -> tuple[int, int]:
    """Teacher-force ``params`` on ``dev`` with the tokens ``want`` (another
    run's greedy output); at each step its argmax must be the wanted token
    wherever its top-2 margin exceeds ``margin``.  The batch is what
    ``Engine.generate`` prefills: the tokens, and zero frames for an
    encoder-decoder config.  Returns (steps checked, steps whose margin
    was too small to judge)."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    B, L = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((B, L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["frames"] = np.zeros((B, cfg.encoder_seq, cfg.d_model), np.float32)
    checked = unsure = 0
    logits, cache = prefill(cfg, params, batch, init_cache(cfg, B, max_seq, torch.float32, dev))
    for step in range(max(len(w) - len(p) for w, p in zip(want, prompts))):
        last = logits[:, -1].float().cpu()
        top = torch.topk(last, 2).values
        fed = np.zeros((B, 1), np.int32)
        for i, (w, p) in enumerate(zip(want, prompts)):
            if step < len(w) - len(p):
                fed[i, 0] = int(w[len(p) + step])
                if float(top[i, 0] - top[i, 1]) > margin:
                    assert int(torch.argmax(last[i])) == fed[i, 0], (i, step)
                    checked += 1
                else:
                    unsure += 1
        logits, cache = decode_step(cfg, params, cache, fed, L + step)
    return checked, unsure


def smoke_card_vs_cpu(dev, arch: str) -> dict:
    """Phase 10e: the smoke config of ``arch`` (float32) on the card against
    its CPU run, same parameters and batch (the frontend's frames or patch
    embeddings too): hidden, prefill and decode logits within ``F32_TOL``,
    greedy tokens (text only, as ``Engine.generate`` serves) teacher-forced
    under the margin rule."""
    import torch

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import decode_step, forward_hidden, init_cache, init_model, prefill
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_map

    cfg = smoke(get_config(arch))
    cpu = init_model(cfg, torch.Generator().manual_seed(SEED))
    gpu = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(SEED + 21)
    toks = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :64], **frontend_inputs(cfg, 2, rng)}
    P = stream_extra(batch)
    runs = {}
    for name, p, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        h, _ = forward_hidden(cfg, p, batch)
        lp, cache = prefill(cfg, p, batch, init_cache(cfg, 2, 72 + P, torch.float32, d))
        ld, _ = decode_step(cfg, p, cache, toks[:, 64:], 64 + P)
        runs[name] = [t.cpu() for t in (h, lp, ld)]
    err = max(max_abs(a, b) for a, b in zip(runs["gpu"], runs["cpu"]))
    for a, b in zip(runs["gpu"], runs["cpu"]):
        torch.testing.assert_close(a, b, atol=F32_TOL, rtol=F32_TOL)
    prompts = [toks[0, :n] for n in (9, 33, 64)]
    scfg = ServeConfig(max_seq=80, max_new_tokens=12)
    want = Engine(cfg, cpu, scfg, device="cpu").generate(prompts)
    got = Engine(cfg, gpu, scfg, device=dev).generate(prompts)
    checked, unsure = forced_greedy(cfg, gpu, prompts, want, scfg.max_seq, dev, 2 * F32_TOL)
    return {"max_abs_err": err, "greedy_checked": checked, "greedy_unsure": unsure,
            "generate_equal": all(np.array_equal(a, b) for a, b in zip(got, want))}


def calibration_check(eng, batches: list, T_cal: int = 512, q: float = 0.999, forward_reps: int = 3):
    """``eng.calibrate`` of ``batches`` on the card, its launches counted:
    each batch's summary (the row sort) bit-equal to its CPU run, the merge
    and the clip to the plain merge's, the clip's rank within the bound of
    an exact sort of all the values; then the path's two kernels timed at
    its shapes beside ``torch.sort`` and their bounds.  Returns (launches,
    the check, the kernels' times, calibrate ms, one forward's ms)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.histogram import build_exact, merge_list, quantile

    kernels.reset_launches()
    calib, calib_ms, _ = event_call(lambda: eng.calibrate(batches, q=q, T=T_cal))
    launches = kernels.reset_launches()
    assert launches["tile_sort"] >= len(batches) and launches["merge_cut"] >= 1, launches
    values = [eng.calibration_values(b) for b in batches]
    forward_ms = cuda_ms(lambda: eng.calibration_values(batches[0]), reps=forward_reps)
    cpu_sums = []
    for v in values:
        card, host = build_exact(v, T_cal), build_exact(v.cpu(), T_cal)
        assert torch.equal(card.boundaries.cpu(), host.boundaries) and torch.equal(card.sizes.cpu(), host.sizes)
        cpu_sums.append(host)
    sums = [build_exact(v, T_cal) for v in values]
    merged, plain = merge_list(sums, 254), merge_list(cpu_sums, 254)
    assert torch.equal(merged.boundaries.cpu(), plain.boundaries) and torch.equal(merged.sizes.cpu(), plain.sizes)
    assert calib["clip"] == float(quantile(plain, np.float32(q))), calib
    N = sum(v.numel() for v in values)
    stream = sum(b["tokens"].size + stream_extra(b) * b["tokens"].shape[0] for b in batches)  # patches too
    assert calib["n_calibration_values"] == N == stream * eng.cfg.d_model
    allv = torch.cat(values)
    lt, le = int((allv < calib["clip"]).sum()), int((allv <= calib["clip"]).sum())
    off = max(0.0, lt - q * N, q * N - le)
    assert off <= calib["rank_error_bound"], (off, calib)
    n = values[0].numel()
    timed = {
        "row_sort_ms": cuda_ms(lambda: build_exact(values[0], T_cal), reps=10),
        "torch_sort_ms": cuda_ms(lambda: torch.sort(values[0]), reps=10),
        "row_sort_bound_ms": bound_ms(row_sort_cost(1, n, T_cal)[0], 0)[0],
        "merge_ms": cuda_ms(lambda: merge_list(sums, 254), reps=20),
        "merge_bound_ms": merge_bound_ms(1, len(sums), T_cal + 1, 254),
        "shapes": {"row_sort": [1, n], "merge": [1, len(sums), T_cal + 1, 254]},
    }
    return launches, {**calib, "rank_off": off, "launches": launches}, timed, calib_ms, forward_ms


def model_serving(dev) -> tuple[dict, dict]:
    """Phase 10, the model-serving path (``repro_torch.models``,
    ``serve.Engine``, ``launch.serve``) at Qwen3-8B's full width and depth:

    a–d. ``serve_at_width``: ``init_model`` (float32, 8.19e9 parameters, a
       seeded generator on the card) and an ``Engine`` (its bfloat16 copy
       of the block weights); ``generate`` of 4 ragged prompts (37, 128,
       301, 512 tokens; 32 new each, greedy, float32 KV cache of 576),
       then of the 512 alone; prefill and a decode step timed with CUDA
       events and traced; ``prefill(x[:257])`` against ``prefill(x[:256])``
       + ``decode_step``, B = 2, in float32 and in bfloat16; the batch's
       logits in bfloat16 against float32 (the same parameters), and the
       greedy first tokens under the margin rule;
    e. the smoke configs of qwen3-8b and gemma2-9b, card against CPU;
    f. ``calibrate`` of 4 batches of (2, 512) tokens, q = 0.999, T = 512:
       each summary bit-equal to its CPU run, the merge and the clip to the
       plain merge's, the clip's rank within the bound of an exact sort of
       all 16.8 M values, and the row sort and the merge launched;
    g. ``launch.serve.main`` at full width with a metrics sidecar and a
       replica (``build/serve-*``, removed after): the pushed update and
       the replica's answer printed, the replica's bit-equal to the
       primary's.

    The launch counts are those of f's ``calibrate`` and g's launcher.
    Returns them and the measurements."""
    import contextlib
    import dataclasses
    import gc
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    gc.collect()
    torch.cuda.empty_cache()
    torch.zeros(1, device=dev)  # the allocator's stats exist once it has allocated
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    laps = {}

    def lap(name: str) -> None:  # wall seconds of each step of the phase
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    # a-d. the model, generate, decode against prefill, bfloat16 against float32
    cfg = get_config("qwen3-8b")
    rng = np.random.default_rng(SEED + 20)
    with torch.no_grad():
        eng, params, res = serve_at_width(dev, cfg, dataclasses.replace(cfg, compute_dtype="float32"), rng,
                                          BF16_RMS_TOL, BF16_MAX_TOL)
    ms = res["ms"]

    lap("a-d")
    # e. card against CPU at smoke width
    res["smoke_card_vs_cpu"] = {a: smoke_card_vs_cpu(dev, a) for a in ("qwen3-8b", "gemma2-9b")}

    lap("e")
    # f. calibrate
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)} for _ in range(4)]
    launches, res["calibrate"], res["calibrate_kernels"], ms["calibrate"], ms["calibration_forward"] = \
        calibration_check(eng, batches)

    lap("f")
    # g. the launcher at full width
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="serve-", dir=os.path.join(ROOT, "build"))
    try:
        out = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(out):
            run, ms["launcher"], _ = event_call(lambda: launcher.main([
                "--arch", "qwen3-8b", "--device", str(dev), "--batch", "4", "--prompt-len", "64", "--max-new-tokens", "16",
                "--metrics-dir", os.path.join(root, "primary"), "--replicate-to", os.path.join(root, "replica"),
            ]))
        served = kernels.reset_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    printed = out.getvalue()
    for ln in printed.splitlines():
        log(f"launcher: {ln}" if not ln.startswith("req") else f"launcher: {ln[:120]}")
    assert "pushed update:" in printed and "replica answer:" in printed, printed
    assert run["update"] is not None and not run["replica"].degraded
    assert same_answer(run["primary"], run["replica"]), (run["primary"], run["replica"])
    launches = {k: launches[k] + served[k] for k in launches}
    res["launcher_launches"] = served
    lap("g")
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    assert peak < total, (peak, total)
    res.update(laps_s=laps, peak_memory_bytes=peak, card_memory_bytes=total,
               path_s=time.perf_counter() - t_phase)
    log(f"model serving: qwen3-8b {res['params']} parameters; {json.dumps(ms)}; bounds {json.dumps(res['bounds_ms'])}")
    log(f"model serving: generate {json.dumps(res['generate'])}")
    log(f"model serving: decode vs prefill {json.dumps(res['decode_vs_prefill'])}; bf16 vs f32 {json.dumps(res['bf16_vs_f32'])}; "
        f"smoke card vs CPU {json.dumps(res['smoke_card_vs_cpu'])}")
    log(f"model serving: calibrate {json.dumps(res['calibrate'])}; its kernels "
        f"{json.dumps(res['calibrate_kernels'])}; launches {launches}")
    log(f"model serving: peak memory {peak} of {total} bytes (torch.cuda.max_memory_allocated); "
        f"traced {json.dumps(res['traced'])}; generate's idle share from them "
        f"{res['generate_idle_share_derived']:.3f}; phase {res['path_s']:.1f} s, "
        f"by step {json.dumps(laps)}")
    return launches, res


# ----------------------------------------------------------------- phase 11

# phase 11's tolerances, set before its first run:
# - a. one float32 train step at smoke width, card against CPU (quantile
#   clipping, no compression): loss and grad norm within rel 1e-5 (reduction
#   orders differ; phase 10 measured ~4e-6 on logits at this width), the clip
#   threshold within rel 1e-4 (a gradient value picked by rank); parameters:
#   AdamW's first step moves an entry by lr * g / (|g| + eps), which the
#   gradients' last-bit gap flips where |g| is near eps, so at most 0.1 % of
#   the entries may differ by more than 1e-6 and none by more than lr;
TRAIN_F32_TOL, TRAIN_THR_TOL = 1e-5, 1e-4
# - b. the restart: the reference restart test's rel 1e-4.
RESTART_TOL = 1e-4
# the row sort's and the merge's own kernels in a trace (csrc/row_sort.cu,
# csrc/radix_sort.cuh; the kv sort shares them, and runs in no merge here)
ROW_SORT_KERNELS = ("onesweep_kernel", "histogram_kernel", "digit_scan_kernel", "resident_kernel",
                    "gather_cuts_kernel")
# a traced step's device time by kind of kernel (first match wins)
STEP_CATEGORIES = (
    ("row_sort", ROW_SORT_KERNELS), ("merge", MERGE_KERNELS),
    ("gemm_f32", ("f32f32", "sgemm", "gemmSN")), ("gemm_bf16", ("bf16", "nvjet", "gemm")),
    ("softmax", ("softmax",)), ("reduce", ("reduce_kernel",)), ("elementwise", ("elementwise",)),
    ("copy", ("Memcpy", "Memset", "copy")),
)
TRAIN_SEQ, TRAIN_BATCH = 2048, 16  # SmolLM-135M's context × the example's batch: 32,768 tokens a step


def train_settings():
    """Phase 11's optimizer and compression (``examples/train_lm.py``'s
    flags: quantile clipping, ρ = 0.01)."""
    from repro_torch.optim import CompressionConfig, OptimizerConfig

    return (OptimizerConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=16, clip_mode="quantile"),
            CompressionConfig(enabled=True, rho=0.01))


def train_bound_ms(cfg, B: int, S: int) -> dict:
    """The least time of a train step under ``remat_policy="full"``: every
    matmul runs 4 times (forward, its recompute, two backward products):
    the bfloat16 block GEMMs at the tensor-core rate; the float32 attention
    core (QKᵀ and PV, unmasked) and the float32 loss einsum at the float32
    rate.  Bytes (parameters, moments, residual: a few GB) bound far less."""
    d, L = cfg.d_model, cfg.num_layers
    blk = L * (d * cfg.head_dim * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) + 3 * d * cfg.d_ff)
    parts = {
        "block_gemms_bf16": 2 * blk * B * S * 4 / PEAK_FLOPS * 1e3,
        "attention_core_f32": 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim * L * 4 / F32_FLOPS * 1e3,
        "loss_f32": 2 * B * S * cfg.vocab_size * d * 4 / F32_FLOPS * 1e3,
    }
    return {"ms": sum(parts.values()), "by": "operations", "parts_ms": parts, "block_params": blk}


def train_card_vs_cpu(dev, arch: str) -> dict:
    """Phase 11a: one float32 train step of the smoke config of ``arch`` on
    the card against its CPU run, same parameters and batch (with the
    frontend's frames or patch embeddings)."""
    import torch

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_model
    from repro_torch.train import make_opt_state, make_train_step
    from repro_torch.tree import flatten_with_path, leaves, tree_map

    cfg = smoke(get_config(arch))
    opt, _ = train_settings()
    cpu = init_model(cfg, torch.Generator().manual_seed(SEED))
    gpu = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(SEED + 30)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32),
             "mask": np.ones((4, 64), np.float32), **frontend_inputs(cfg, 4, rng)}
    batch["tokens"] = batch["tokens"][:, stream_extra(batch):]  # the patches take the first positions
    step = make_train_step(cfg, opt)
    runs = {name: step(p, make_opt_state(p, opt), batch) for name, p in (("cpu", cpu), ("gpu", gpu))}
    (pc, _, mc), (pg, _, mg) = runs["cpu"], runs["gpu"]
    assert pg["embed"].device.type == dev.type
    out = {"rel_err": {}}
    for k, tol in (("loss", TRAIN_F32_TOL), ("grad_norm", TRAIN_F32_TOL), ("clip_threshold", TRAIN_THR_TOL)):
        a, b = float(mg[k]), float(mc[k])
        out["rel_err"][k] = abs(a - b) / abs(b)
        assert out["rel_err"][k] <= tol, (arch, k, a, b)
    lr = float(mc["lr"])
    off = far = total = 0
    for (name, a), b in zip(flatten_with_path(pg), leaves(pc)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= lr, (arch, name, float(d.max()), lr)
        off, far, total = max(off, float(d.max())), far + int((d > 1e-6).sum()), total + d.numel()
    assert far <= 1e-3 * total, (arch, far, total)
    out.update(param_max_abs=off, params_off_1e6=far, params=total, loss=float(mc["loss"]))
    return out


def training(dev) -> tuple[dict, dict]:
    """Phase 11, the training path (``models.loss_fn``, ``train``,
    ``checkpoint``, ``launch.train``) at SmolLM-135M's full width and depth
    (30 layers, d 576, vocab 49,152, tied; bfloat16 compute,
    ``remat_policy="full"``), seq 2,048 × batch 16, quantile clipping and
    compression at ρ = 0.01:

    a. one float32 step at the smoke widths of smollm-135m and qwen3-8b, on
       the card against the CPU;
    b. a ``Trainer`` of 8 steps, checkpointing every 4 (``build/train-*``,
       removed after); ``LATEST`` pointed back at step 4, as a crash before
       step 8's save leaves it, and a second ``Trainer`` on the same
       directory resumes at 4 and runs to 8: its losses at 5–8 equal the
       first run's within ``RESTART_TOL``, the last below the first;
    c. the first step's gradient tree (``make_grad_fn``) through the
       card's ``grad_quantile``, clipping's and compression's (on the
       clipped tree), against the plain versions on the same gradients on
       the CPU: every leaf's summary, the merged boundaries and the
       clipping threshold bit-equal, the merged sizes within the float32
       scan's error bound, both thresholds within Theorem 1;
    d. ``python -m repro_torch.launch.train`` at full width in a
       subprocess, its printout checked;
    e. a step timed (CUDA events) and traced, its device time by kind
       (the row sort's and the merge's share), the embedding leaf's row
       sort and the step's merge beside
       ``torch.sort`` and their bounds, a checkpoint's save and restore, the
       step's peak device memory and its bound.

    The launch counts are those of b's two Trainers (12 steps).  Returns
    them and the measurements."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.histogram import Histogram, build_exact, merge_list, quantile
    from repro_torch.core.telemetry import grad_quantile, tree_summaries
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.models import init_model
    from repro_torch.train import Trainer, TrainerConfig, make_grad_fn, make_train_step
    from repro_torch.tree import flatten_with_path, leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.zeros(1, device=dev)  # the allocator's stats exist once it has allocated
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    res, laps = {}, {}

    def lap(name: str) -> None:
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    # a. card against CPU at smoke width
    res["smoke_card_vs_cpu"] = {a: train_card_vs_cpu(dev, a) for a in ("smollm-135m", "qwen3-8b")}
    lap("a")

    # b. the Trainer at full width, and its restart
    cfg = get_config("smollm-135m")
    assert cfg.remat_policy == "full" and cfg.compute_dtype == "bfloat16" and cfg.num_layers == 30
    opt, comp = train_settings()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train-", dir=os.path.join(ROOT, "build"))
    try:
        ckpt = os.path.join(root, "ckpt")
        tcfg = TrainerConfig(total_steps=8, log_every=1, checkpoint_every=4, checkpoint_dir=ckpt, seed=SEED)

        def trainer(losses: dict):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                tr = Trainer(cfg, opt, tcfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, comp_cfg=comp, device=dev)
                start = tr.start_step
                t0 = time.perf_counter()
                tr.run(on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
                run_s = time.perf_counter() - t0
            for ln in out.getvalue().splitlines():
                log(f"trainer: {ln}")
            return tr, start, run_s

        want, got = {}, {}
        kernels.reset_launches()
        tr, start_a, run_a = trainer(want)
        del tr
        # LATEST back at step 4, atomically, as a crash before step 8's save leaves it
        with open(os.path.join(ckpt, "LATEST.tmp"), "w") as f:
            f.write("step_00000004")
        os.replace(os.path.join(ckpt, "LATEST.tmp"), os.path.join(ckpt, "LATEST"))
        tr, start_b, run_b = trainer(got)
        launches = kernels.reset_launches()
        assert start_a == 0 and start_b == 4, (start_a, start_b)
        assert sorted(want) == list(range(1, 9)) and sorted(got) == list(range(5, 9)), (want, got)
        for s in got:
            assert abs(got[s] - want[s]) <= RESTART_TOL * abs(want[s]), (s, got[s], want[s])
        assert want[8] < want[1], want
        assert all(np.isfinite(v) for v in want.values())
        for name in ("tile_sort", "merge_cut"):
            assert launches[name] > 0, f"training path never launched {name}: {launches}"
        res["trainer"] = {"losses": want, "resumed_losses": got, "run_s": run_a, "resumed_run_s": run_b,
                          "launches": launches, "launches_per_step": {k: v / 12 for k, v in launches.items()}}
        lap("b")

        # c. the first step's gradient tree: the card's kernels against the plain versions
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=SEED)
        batch = shard_batch(data.batch_at(0), device=dev)
        params0 = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        (loss0, _), grads = make_grad_fn(cfg)(params0, batch)
        assert abs(float(loss0) - want[1]) <= RESTART_TOL * want[1], (float(loss0), want[1])
        del params0
        thr = grad_quantile(grads, opt.clip_q, opt.clip_hist_T)
        clipped = tree_map(lambda g: torch.clamp(g, -thr, thr), grads)
        cthr = grad_quantile(clipped, 1.0 - comp.rho, comp.hist_T)
        assert thr.device.type == cthr.device.type == dev.type
        merges = {}
        # the plain versions' grad_quantile, step by step: the summaries of the
        # same gradients on the CPU, their merge, its quantile
        for tag, tree, q, T_, t_card in (("clip", grads, opt.clip_q, opt.clip_hist_T, thr),
                                         ("compress", clipped, 1.0 - comp.rho, comp.hist_T, cthr)):
            hs = list(tree_summaries(tree, T_).values())
            hc = list(tree_summaries(tree_map(lambda g: g.cpu(), tree), T_).values())
            for i, (h, c) in enumerate(zip(hs, hc)):
                assert same_hist(h, c), f"{tag}: gradient leaf {i}'s summary"
            width = max(h.sizes.shape[-1] for h in hs)
            mg, mc = merge_list(hs, width), merge_list(hc, width)
            assert torch.equal(mg.boundaries.cpu(), mc.boundaries), f"{tag}: merged boundaries"
            N = float(mc.sizes.double().sum())
            L = len(hs) * (width + 1)
            # above 2^24 total mass the float32 scans of the merge kernel and of the
            # plain merge (torch.cumsum) round in different orders (ROADMAP Queue 3):
            # sizes within twice the error bound of an L-term float32 sum, 2·L·2^-24·N
            size_off = float((mg.sizes.cpu().double() - mc.sizes.double()).abs().max())
            assert size_off <= 2 * L * 2.0**-24 * N, (tag, size_off, L, N)
            assert N > 2**24 or torch.equal(mg.sizes.cpu(), mc.sizes), tag
            t_cpu = quantile(mc, torch.full((), q, dtype=torch.float32))
            if tag == "clip":  # the clipping threshold: bit-equal (it was in every run so far)
                assert torch.equal(t_card.cpu(), t_cpu), (float(t_card), float(t_cpu))
            lt, le = rank_window(leaves(tree), t_card)
            off = max(0.0, lt - q * N, q * N - le)
            assert off <= 2 * N / T_, (tag, off, N, T_)  # the threshold's rank bound (Theorem 1)
            merges[tag] = {"total_mass": N, "merged_sizes_max_abs_diff": size_off,
                           "sizes_bound": 2 * L * 2.0**-24 * N, "threshold": float(t_card),
                           "threshold_cpu": float(t_cpu), "threshold_equal": bool(torch.equal(t_card.cpu(), t_cpu)),
                           "rank_off_over_bound": off / (2 * N / T_)}
        names = [n for n, _ in flatten_with_path(grads)]
        res["grad_tree"] = {"leaves": len(names), "values": sum(g.numel() for g in leaves(grads)),
                            "largest_leaf": max((g.numel(), n) for n, g in flatten_with_path(grads)),
                            "clip_threshold": float(thr), "compress_threshold": float(cthr), "merges": merges}
        # the path's two kernels at its shapes, beside torch.sort and their bounds
        sums = tree_summaries(grads, opt.clip_hist_T)
        emb = grads["embed"].abs().reshape(-1)
        n = emb.numel()
        res["kernels"] = {
            "grad_quantile_ms": cuda_ms(lambda: grad_quantile(grads, opt.clip_q, opt.clip_hist_T), reps=5),
            "embed_row_sort_ms": cuda_ms(lambda: build_exact(emb, opt.clip_hist_T), reps=10),
            "embed_torch_sort_ms": cuda_ms(lambda: torch.sort(emb), reps=10),
            "embed_row_sort_bound_ms": bound_ms(row_sort_cost(1, n, opt.clip_hist_T)[0], 0)[0],
            "merge_ms": cuda_ms(lambda: merge_list(list(sums.values()), opt.clip_hist_T), reps=20),
            "merge_bound_ms": merge_bound_ms(1, len(sums), opt.clip_hist_T + 1, opt.clip_hist_T),
            "shapes": {"embed_row_sort": [1, n], "merge": [1, len(sums), opt.clip_hist_T + 1, opt.clip_hist_T]},
        }
        del clipped, emb, sums
        lap("c")

        # e. a step timed and traced, its memory, a checkpoint's save and restore
        step = make_train_step(cfg, opt, comp_cfg=comp)
        params, state = tr.params, tr.opt_state
        del tr
        batch = shard_batch(data.batch_at(8), device=dev)
        step(params, state, batch)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = cuda_ms(lambda: step(params, state, batch), reps=3)
        step_peak = torch.cuda.max_memory_allocated(dev)
        prof, wall, events, lost, _ = traced(lambda: step(params, state, batch), retries=2)
        items, ops = device_items(prof)
        busy = sum(items.values()) / 1e3
        top = sorted(items.items(), key=lambda kv: -kv[1])[:8]
        by_category = {}
        for key, t in items.items():
            cat = next((c for c, marks in STEP_CATEGORIES if any(m in key for m in marks)), "other")
            by_category[cat] = by_category.get(cat, 0.0) + t / 1e3
        bound = train_bound_ms(cfg, TRAIN_BATCH, TRAIN_SEQ)
        res["step"] = {
            "ms": step_ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            "bound_ms": bound["ms"], "bound_by": bound["by"], "bound_parts_ms": bound["parts_ms"],
            "peak_memory_bytes": step_peak,
            "traced": {"wall_ms": wall * 1e3, "events_ms": events, "device_ms": busy, "device_ops": ops,
                       "idle_share": 1.0 - busy / (wall * 1e3), "lost_launches": lost,
                       "top_device_ms": {k[:60]: t / 1e3 for k, t in top}, "device_ms_by_category": by_category},
            "kernels_share": (by_category.get("row_sort", 0.0) + by_category.get("merge", 0.0)) / busy,
        }
        save_dir = os.path.join(root, "timed")
        t0 = time.perf_counter()
        path = save_checkpoint(save_dir, 8, params, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, back_state, _ = restore_checkpoint(save_dir, None, params, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for a, b in zip(leaves((params, state)), leaves((back, back_state))):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        res["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                             "bytes": os.path.getsize(os.path.join(path, "arrays.npz"))}
        del back, back_state, params, state, grads, batch
        gc.collect()
        torch.cuda.empty_cache()
        lap("e")

        # d. the launcher at full width, in its own process
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m", "--steps", "2",
               "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH), "--clip-mode", "quantile",
               "--log-every", "1", "--checkpoint-dir", os.path.join(root, "launcher")]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        launcher_s = time.perf_counter() - t0
        for ln in run.stdout.splitlines():
            log(f"train launcher: {ln}")
        assert run.returncode == 0, run.stderr[-4000:]
        lines = run.stdout.splitlines()
        steps = [ln for ln in lines if ln.startswith("[trainer] step=")]
        assert [ln.split()[1] for ln in steps] == ["step=1", "step=2"], lines
        assert all(np.isfinite(float(ln.split()[2].removeprefix("loss="))) for ln in steps), lines
        assert lines[-1].startswith("[trainer] done: 2 steps"), lines
        res["launcher_s"] = launcher_s
        lap("d")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res.update(laps_s=laps, peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               path_s=time.perf_counter() - t_phase)
    log(f"training: smoke card vs CPU {json.dumps(res['smoke_card_vs_cpu'])}")
    log(f"training: trainer {json.dumps(res['trainer'])}")
    log(f"training: grad tree {json.dumps(res['grad_tree'])}; kernels {json.dumps(res['kernels'])}")
    log(f"training: step {json.dumps(res['step'])}")
    log(f"training: checkpoint {json.dumps(res['checkpoint'])}; launcher {launcher_s:.1f} s; "
        f"phase {res['path_s']:.1f} s, by step {json.dumps(laps)}")
    return launches, res


# ----------------------------------------------------------------- phase 12

# phase 12's tolerances: phase 10's and phase 11a's, except bfloat16 against
# float32 for the model with Mamba layers: its bfloat16 program (bfloat16
# compute and scan, the config's) rounds Δ before exp(Δ·A), where |Δ·A| up
# to ~10 turns Δ's 2^-9 into ~2 % of a decay, carried along the state; the
# reference's own bfloat16 logits sit 0.031–0.048 (rms) from its float32
# ones at jamba's smoke width (CPU, XLA, dropless; tests/test_torch_models.py::
# test_bf16_logits_sit_as_far_from_float32_as_the_references), and a run of this
# phase measured 0.051–0.066 at full width on the rows whose routing
# agreed (0.23–0.33 max); so rms 0.10 and, as phase 10 scales them, max
# 5 × that.
MAMBA_BF16_RMS_TOL, MAMBA_BF16_MAX_TOL = 0.10, 0.50


def stack_bounds_ms(cfg, blocks, B: int, L: int, max_seq: int, kept: float, enc_blocks=None) -> dict:
    """Least times of a prefill of B × L stream positions (the patches
    among them) and of a decode step of B tokens (float32 caches of
    ``max_seq``) for the bfloat16 model ``cfg``, whose compute-dtype
    blocks are ``blocks`` (and the encoder's ``enc_blocks``): the larger
    of operations and bytes each.
    - operations: the block matmuls at the bfloat16 tensor-core rate
      (attention, cross-attention, Mamba and RWKV projections, MLPs, the
      experts for the routed tokens that were kept: ``kept`` = k × (1 −
      drop fraction) a token; the encoder's layers over ``encoder_seq``
      frames); at the float32 rate the router, the attention cores (QKᵀ
      and PV, unmasked; the encoder's and the cross-attention's over
      ``encoder_seq`` keys), the Mamba scan (about 10 operations an element
      of (L, d_inner, d_state)), the RWKV decay LoRA and recurrence (7
      operations an element of a head's (hd × hd) state a step) and the
      last position's logits;
    - bytes: the bfloat16 block weights (decode: of the experts that B
      tokens can reach, min(E, B·k) a layer, and not the encoder's) and
      the float32 unembedding read once, plus the caches read once in
      decode (the cross-attention's keys and values among them)."""
    from repro_torch.tree import leaves

    d, f, V, E, k = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_experts, cfg.num_experts_per_token
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d_in, n, r = cfg.mamba_expand * d, cfg.mamba_d_state, max(d // 16, 1)
    blk = sum(t.numel() * t.element_size() for t in leaves(blocks) if t.dtype.itemsize == 2)
    enc_blk = sum(t.numel() * t.element_size() for t in leaves(enc_blocks) if t.dtype.itemsize == 2)
    mlp = (2 if cfg.norm_type == "layernorm" else 3) * d * f
    Se = cfg.encoder_seq
    bf16 = f32 = 0.0
    cache = 0.0
    unread_experts = 0.0
    for kind in cfg.pattern:
        mixer, ffn = kind.split("+")[0], kind.split("+")[-1]
        if kind == "rwkv":
            rwkv_hd = d // cfg.rwkv_heads
            bf16 += 2 * B * L * (6 * d * d + 2 * d * f)
            f32 += 2 * B * L * 2 * d * cfg.rwkv_decay_lora + 7 * B * L * d * rwkv_hd
            cache += 4 * B * (d * rwkv_hd + 2 * d)
            continue
        if mixer == "mamba":
            bf16 += 2 * B * L * (2 * d * d_in + d_in * (r + 2 * n) + r * d_in + d_in * d)
            f32 += 10 * B * L * d_in * n + 2 * B * L * d_in * cfg.mamba_d_conv
            cache += 4 * B * d_in * (n + cfg.mamba_d_conv - 1)
        else:
            bf16 += 2 * B * L * (d * hd * (H + 2 * Hkv) + H * hd * d)
            f32 += 2 * 2 * B * H * L * L * hd
            cache += 4 * 2 * B * max_seq * Hkv * hd
        if "cross" in kind:
            bf16 += 2 * B * L * 2 * d * H * hd + 2 * B * Se * 2 * d * Hkv * hd
            f32 += 2 * 2 * B * H * L * Se * hd
            cache += 4 * 2 * B * Se * Hkv * hd
        if ffn == "moe":
            bf16 += 2 * 3 * d * f * kept * B * L
            f32 += 2 * B * L * d * E
            unread_experts += (E - min(E, B * k)) * 3 * d * f * 2
        else:
            bf16 += 2 * B * L * mlp
    bf16, f32, cache, unread_experts = (x * cfg.repeats for x in (bf16, f32, cache, unread_experts))
    if cfg.is_encoder_decoder:  # non-causal attention and MLP layers over the frames
        bf16 += cfg.encoder_layers * 2 * B * Se * (d * hd * (H + 2 * Hkv) + H * hd * d + mlp)
        f32 += cfg.encoder_layers * 2 * 2 * B * H * Se * Se * hd
    f32 += 2 * B * V * d
    unembed = 4 * V * d
    ops_ms = (bf16 / PEAK_FLOPS + f32 / F32_FLOPS) * 1e3
    prefill_bytes_ms = (blk + enc_blk + unembed) / HBM_BW * 1e3
    decode_bytes_ms = (blk - unread_experts + unembed + cache) / HBM_BW * 1e3
    return {
        "prefill": max(ops_ms, prefill_bytes_ms), "prefill_by": "operations" if ops_ms >= prefill_bytes_ms else "bytes",
        "decode_step": decode_bytes_ms, "decode_step_by": "bytes",
        "prefill_ops_bf16": bf16, "prefill_ops_f32": f32, "block_bytes_bf16": blk + enc_blk,
    }


def expected_params(cfg) -> int:
    """``ModelConfig.param_count`` plus what it leaves out: the norms (two
    a layer, a cross layer's ``ln_x``, the final one and the encoder's;
    a layer norm's bias beside its gain), attention's qk-norm gains, the
    ungated MLP's biases (d_ff + d), the Mamba mixer's conv bias, dt bias
    and D (d_inner each), and RWKV's vectors (5 + 2 token-shift mixes,
    ``w0``, ``u`` and the output norm's gain and bias: 11·d a layer)."""
    d = cfg.d_model
    norm = (2 if cfg.norm_type == "layernorm" else 1) * d
    qk = 2 * cfg.head_dim if cfg.qk_norm else 0

    def layer(kind: str) -> int:
        parts = kind.split("+")
        if kind == "rwkv":
            return 2 * norm + 11 * d
        n = 2 * norm + (3 * cfg.mamba_expand * d if parts[0] == "mamba" else qk)
        if "cross" in parts:
            n += norm + qk
        if parts[-1] == "mlp" and cfg.norm_type == "layernorm":
            n += cfg.d_ff + d
        return n

    total = cfg.param_count() + sum(layer(k) for k in cfg.pattern) * cfg.repeats + norm
    if cfg.is_encoder_decoder:
        total += cfg.encoder_layers * layer("attn+mlp") + norm
    return total


def bf16_against_f32(cfg, cfg32, run16, run32, batch: dict, rms_tol: float, max_tol: float) -> dict:
    """The last position's logits of ``batch`` in bfloat16 (``cfg``,
    ``run16``) against float32 (``cfg32``, ``run32``), each from one
    forward that also gives its routing.  A top-k choice or a capacity
    drop that a rounding flips moves a token's expert output by O(1) (one
    of its k experts is another), so a row is held only where its last
    position's routing — experts in slot order, and which were kept — is
    the same in both precisions in every MoE layer: its rms difference
    within ``rms_tol`` and its largest within ``max_tol`` of the row's
    float32 rms, and its greedy token equal where the float32 top-2
    margin exceeds ``max_tol`` of that rms.  At least half the rows must
    agree (without MoE layers, all do).  Rows that differ are counted and
    reported."""
    import torch

    from repro_torch.models import forward_hidden
    from repro_torch.models.common import softcap

    rows = {}
    for name, c, run in (("bf16", cfg, run16), ("f32", cfg32, run32)):
        with torch.no_grad():
            h, aux = forward_hidden(c, run, batch)
        unemb = run["embed"] if c.tie_embeddings else run["unembed"]
        rows[name] = (softcap(h[:, -1].float() @ unemb.float().T, c.final_softcap),
                      [a["routing"][:, -1] for a in aux.get("moe_layers", [])])
        del h, aux
    (l16, r16), (l32, r32) = rows["bf16"], rows["f32"]
    agree = [all(torch.equal(a[i], b[i]) for a, b in zip(r16, r32)) for i in range(l32.shape[0])]
    out = {"rows_routing_agrees": agree, "rms_diff_over_rms": [], "max_over_rms": [], "greedy_judged": 0,
           "greedy_equal": int(sum(int(torch.argmax(l16[i]) == torch.argmax(l32[i])) for i in range(len(agree)))),
           "all_rows_rms_diff_over_rms": rms(l16 - l32) / rms(l32)}
    for i, ok in enumerate(agree):
        scale = rms(l32[i])
        out["rms_diff_over_rms"].append(rms(l16[i] - l32[i]) / scale)
        out["max_over_rms"].append(float((l16[i] - l32[i]).abs().max()) / scale)
        if not ok:
            continue
        assert out["rms_diff_over_rms"][i] <= rms_tol and out["max_over_rms"][i] <= max_tol, (i, out)
        top = torch.topk(l32[i], 2).values
        if float(top[0] - top[1]) > max_tol * scale:
            out["greedy_judged"] += 1
            assert int(torch.argmax(l16[i])) == int(torch.argmax(l32[i])), (i, out)
    assert 2 * sum(agree) >= len(agree), out
    return out


def on_card(batch: dict, dev) -> dict:
    """``batch``'s frontend inputs on the card: frames float32, patch
    embeddings bfloat16 (the compute dtype they are cast to)."""
    import torch

    return {k: torch.from_numpy(v).to(dev, torch.bfloat16 if k == "patch_embeds" else torch.float32)
            for k, v in batch.items()}


def cut_depth(cfg, run, repeats: int):
    """``cfg`` and its parameter tree ``run`` with the first ``repeats``
    repeats of the stack (views)."""
    import dataclasses

    from repro_torch.tree import tree_map

    return (dataclasses.replace(cfg, repeats=repeats),
            dict(run, blocks=[tree_map(lambda t: t[:repeats], b) for b in run["blocks"]]))


def serve_at_width(dev, cfg, cfg32, rng, rms_tol: float, max_tol: float, trace_repeats: int | None = None,
                   step_tol: tuple[float, float] = (BF16_RMS_TOL, BF16_MAX_TOL)) -> tuple:
    """Phase 12's and phase 13's steps for one bfloat16 model at full width
    (``cfg``; its float32 twin ``cfg32``): the model and its ``Engine``;
    ``generate`` of 4 ragged prompts (37, 128, 301, 512 tokens; 32 new
    each) and of the 512 alone, after a short warm-up; prefill and a
    decode step timed (CUDA events) and traced (the prefill's trace over
    the first ``trace_repeats`` repeats when given: a trace holds every
    launch), their bounds; the MoE layers' drop fractions, the first MoE
    layer (and its three expert products alone), the first Mamba mixer,
    the first RWKV time mix and the encoder timed at the prefill's shape;
    ``prefill(x[:257])`` against ``prefill(x[:256])`` + ``decode_step``
    (B = 2, dropless: ``moe_capacity_factor=16``) in float32 and bfloat16
    (that within ``step_tol``, rms and max over the rms);
    the batch's logits in bfloat16 against float32 (``bf16_against_f32``,
    with ``rms_tol`` and ``max_tol``).  The frontend's seeded inputs
    (``frontend_inputs``: whisper's frames, pixtral's patch embeddings
    ahead of the text) go with every prefill and forward; ``generate``
    serves text, as the reference's does (whisper's from zero frames).
    Returns (the engine, the float32 parameters, the measurements)."""
    import dataclasses

    import torch

    from repro_torch.models import decode_step, forward_hidden, init_cache, init_model, prefill
    from repro_torch.models.mamba import apply_mamba
    from repro_torch.models.model import _run_encoder
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.rwkv import apply_rwkv_time_mix
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import leaves

    res, ms = {}, {}
    params, ms["init"], _ = event_call(lambda: init_model(cfg, torch.Generator(device=dev).manual_seed(SEED)))
    n_params = sum(t.numel() for t in leaves(params))
    assert n_params == expected_params(cfg), (n_params, expected_params(cfg))
    scfg = ServeConfig(max_seq=576, max_new_tokens=32)
    eng, ms["engine_copy"], _ = event_call(lambda: Engine(cfg, params, scfg, device=dev))

    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in (37, 128, 301, 512)]
    _, ms["warm_up_generate"], _ = event_call(lambda: eng.generate([prompts[0][:8]]))  # first launches load kernels
    outs, gen_ms, gen_wall = event_call(lambda: eng.generate(prompts))
    alone, one_ms, one_wall = event_call(lambda: eng.generate(prompts[-1:]))
    new = [len(o) - len(p) for o, p in zip(outs, prompts)]
    for o, p in zip(outs + alone, prompts + prompts[-1:]):
        assert len(p) < len(o) <= len(p) + scfg.max_new_tokens and np.array_equal(o[:len(p)], p)
        assert int(o.min()) >= 0 and int(o.max()) < cfg.vocab_size
    padded, _ = eng._pad_batch(prompts)
    B, L = padded.shape
    ext = frontend_inputs(cfg, B, rng)
    P = stream_extra(ext)
    batch = {"tokens": padded, **on_card(ext, dev)}
    max_seq = scfg.max_seq + P
    cache = init_cache(cfg, B, max_seq, torch.float32, dev)
    ms["prefill"] = cuda_ms(lambda: prefill(cfg, eng._run, batch, cache), reps=3)
    logits16, cache = prefill(cfg, eng._run, batch, cache)
    tok = torch.argmax(logits16[:, -1], -1, keepdim=True).to(torch.int32)
    ms["decode_step"] = cuda_ms(lambda: decode_step(cfg, eng._run, cache, tok, L + P), reps=10)
    cfg_t, run_t = (cfg, eng._run) if trace_repeats is None else cut_depth(cfg, eng._run, min(trace_repeats, cfg.repeats))
    cache_t = cache if trace_repeats is None else init_cache(cfg_t, B, max_seq, torch.float32, dev)
    res["traced"] = {
        "prefill": device_breakdown(lambda: prefill(cfg_t, run_t, batch, cache_t), retries=2),
        "decode_step": device_breakdown(lambda: decode_step(cfg, eng._run, cache, tok, L + P), retries=2),
    }
    res["traced_prefill_repeats"] = cfg_t.repeats
    del cache, cache_t
    pre, dec = (res["traced"][k]["device_ms"] for k in ("prefill", "decode_step"))
    pre *= cfg.repeats / cfg_t.repeats  # a cut trace scaled to the whole stack
    res["generate_idle_share_derived"] = 1.0 - (pre + (max(new) - 1) * dec) / gen_wall
    res["generate"] = {
        "batch_ms": gen_ms, "batch_wall_ms": gen_wall, "new_tokens": new,
        "tokens_per_s": sum(new) / (gen_wall / 1e3),
        "alone_ms": one_ms, "alone_tokens_per_s": (len(alone[0]) - len(prompts[-1])) / (one_wall / 1e3),
        "longest_alone_equal_batched": bool(np.array_equal(alone[0], outs[-1])),
    }
    # the MoE layers' routing at the batch (prefill routes the same inputs alike)
    with torch.no_grad():
        _, aux = forward_hidden(cfg, eng._run, batch)
    drops = [float(a["moe_drop_fraction"]) for a in aux.get("moe_layers", [])]
    res["moe_drop_fraction"] = drops
    kept = cfg.num_experts_per_token * (1.0 - float(np.mean(drops))) if drops else 0.0
    res["bounds_ms"] = stack_bounds_ms(cfg, eng._run["blocks"], B, L + P, max_seq, kept,
                                       eng._run.get("encoder", {}).get("blocks"))
    if cfg.is_encoder_decoder:
        ms["encoder"] = cuda_ms(lambda: _run_encoder(cfg, eng._run, batch["frames"]), reps=3)
    # the MoE and Mamba mixers alone at the prefill's shape (first of each in the stack)
    x = torch.randn((B, L, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev).to(torch.bfloat16)
    for i, kind in enumerate(cfg.pattern):
        blk = {k: {kk: t[0] for kk, t in v.items()} if isinstance(v, dict) else v[0]
               for k, v in eng._run["blocks"][i].items()}
        if kind.endswith("moe") and "apply_moe" not in ms:
            ms["apply_moe"] = cuda_ms(lambda: apply_moe(cfg, blk["ffn"], x), reps=3)
            # its three expert products alone, on a dispatched (B, nG, E, C, d) block
            g = min(cfg.moe_group_size, L)
            C = max(int(g * cfg.num_experts_per_token * cfg.moe_capacity_factor / cfg.num_experts), 1)
            x_e = x.reshape(B, L // g, g, -1)[:, :, :C, None].expand(-1, -1, -1, cfg.num_experts, -1)
            x_e = x_e.transpose(2, 3).contiguous()
            w = blk["ffn"]

            def experts():
                h = torch.nn.functional.silu(torch.einsum("bnecd,edf->bnecf", x_e, w["w_gate"]))
                h = h * torch.einsum("bnecd,edf->bnecf", x_e, w["w_up"])
                return torch.einsum("bnecf,efd->bnecd", h, w["w_down"])

            ms["moe_experts"] = cuda_ms(experts, reps=3)
            del x_e
        if kind.startswith("mamba") and "apply_mamba" not in ms:
            ms["apply_mamba"] = cuda_ms(lambda: apply_mamba(cfg, blk["mixer"], x), reps=3)
        if kind == "rwkv" and "apply_rwkv_time_mix" not in ms:
            ms["apply_rwkv_time_mix"] = cuda_ms(lambda: apply_rwkv_time_mix(cfg, blk["tm"], x), reps=3)
    del x

    # decode against prefill, dropless, float32 and bfloat16
    xs = rng.integers(2, cfg.vocab_size, (2, 257)).astype(np.int32)
    two = {k: v[:2] for k, v in batch.items() if k != "tokens"}
    step_err = {}
    for name, c, run in (("float32", cfg32, params), ("bfloat16", cfg, eng._run)):
        c = dataclasses.replace(c, moe_capacity_factor=16.0)
        full, _ = prefill(c, run, {"tokens": xs, **two}, init_cache(c, 2, 264 + P, torch.float32, dev))
        _, kv = prefill(c, run, {"tokens": xs[:, :256], **two}, init_cache(c, 2, 264 + P, torch.float32, dev))
        step, _ = decode_step(c, run, kv, xs[:, 256:], 256 + P)
        del kv
        assert bool(torch.isfinite(full).all())
        diff, scale = (step - full).abs(), rms(full)
        step_err[name] = {"max_abs": float(diff.max()), "rms_diff_over_rms": rms(step - full) / scale,
                          "max_over_rms": float(diff.max()) / scale}
        if name == "float32":
            torch.testing.assert_close(step, full, rtol=F32_STEP_TOL, atol=F32_STEP_TOL)
        else:
            assert step_err[name]["rms_diff_over_rms"] <= step_tol[0], step_err
            assert step_err[name]["max_over_rms"] <= step_tol[1], step_err
    res["decode_vs_prefill"] = step_err

    # bfloat16 against float32 on the batch, row by row where the routing agrees
    res["bf16_vs_f32"] = bf16_against_f32(cfg, cfg32, eng._run, params, batch, rms_tol, max_tol)
    res.update(ms=ms, params=n_params,
               block_weights_bf16=sum(t.numel() for t in leaves(eng._run["blocks"]) if t.dtype == torch.bfloat16))
    return eng, params, res


def moe_hybrid_serving(dev) -> tuple[dict, dict]:
    """Phase 12, the MoE and hybrid Mamba families (``models.moe``,
    ``models.mamba``) through ``serve.Engine`` and ``launch.serve``, at
    full width with depth cut — the one cut of each model:

    a–c. DBRX-132B (d 6144, 48 heads, 8 kv heads, 16 experts × d_ff
       10,752, top-4, group 128 so C = 40, vocab 100,352) with
       ``repeats`` 40 → 2: 7.75e9 float32 parameters and the Engine's
       bfloat16 copy of the blocks (three layers would need ≈ 66 GB
       before activations); ``serve_at_width``'s steps;
    d. ``Engine.calibrate`` on DBRX: 2 batches of (2, 512) tokens, q =
       0.999, T = 512 (``calibration_check``);
    e. Jamba-v0.1 (d 4096, 32 heads, 8 kv heads, 16 experts × d_ff 14,336,
       top-2, d_state 16, conv 4, expand 2, chunk 256, bfloat16 scan)
       with its 8-layer super-block cut to one repeat of slots 2–5,
       ("mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe"): every layer
       kind of the config, 6.88e9 parameters (the whole block would need
       ≈ 80 GB with its bfloat16 copy); ``serve_at_width``'s steps, its
       float32 twin with the float32 scan; the 512-token prefill crosses
       two whole chunks, the 37-token prompt has a partial one;
    f. the smoke configs of dbrx-132b, llama4-maverick-400b-a17b and
       jamba-v0.1-52b, card against CPU (``smoke_card_vs_cpu``) and one
       float32 train step each (``train_card_vs_cpu``);
    g. ``launch.serve.main --smoke`` for dbrx-132b and jamba-v0.1-52b on
       the card.

    Each model is freed before the next; each one's peak device memory is
    recorded.  The launch counts are those of d's ``calibrate``.  Returns
    them and the measurements."""
    import contextlib
    import dataclasses
    import gc
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    t_phase = time.perf_counter()
    res, laps = {}, {}
    rng = np.random.default_rng(SEED + 40)

    def lap(name: str) -> None:  # wall seconds of each step of the phase
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    def fresh() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)

    fresh()
    dbrx = dataclasses.replace(get_config("dbrx-132b"), repeats=2)
    with torch.no_grad():
        eng, params, res["dbrx"] = serve_at_width(dev, dbrx, dataclasses.replace(dbrx, compute_dtype="float32"), rng,
                                                  BF16_RMS_TOL, BF16_MAX_TOL)
    lap("a-c dbrx")
    batches = [{"tokens": rng.integers(0, dbrx.vocab_size, (2, 512)).astype(np.int32)} for _ in range(2)]
    launches, res["dbrx"]["calibrate"], res["dbrx"]["calibrate_kernels"], cal_ms, fwd_ms = \
        calibration_check(eng, batches)
    res["dbrx"]["ms"].update(calibrate=cal_ms, calibration_forward=fwd_ms)
    res["dbrx"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    del eng, params
    lap("d calibrate")

    fresh()
    full = get_config("jamba-v0.1-52b")
    jamba = dataclasses.replace(full, pattern=full.pattern[2:6], repeats=1)
    assert jamba.pattern == ("mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe")
    with torch.no_grad():
        eng, params, res["jamba"] = serve_at_width(
            dev, jamba, dataclasses.replace(jamba, compute_dtype="float32", mamba_scan_dtype="float32"), rng,
            MAMBA_BF16_RMS_TOL, MAMBA_BF16_MAX_TOL)
    res["jamba"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    del eng, params
    lap("e jamba")

    fresh()
    archs = ("dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b")
    res["smoke_card_vs_cpu"] = {a: smoke_card_vs_cpu(dev, a) for a in archs}
    res["train_card_vs_cpu"] = {a: train_card_vs_cpu(dev, a) for a in archs}
    lap("f smoke")

    printed = {}
    for arch in ("dbrx-132b", "jamba-v0.1-52b"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run = launcher.main(["--arch", arch, "--smoke", "--device", str(dev), "--batch", "2",
                                 "--max-new-tokens", "8"])
        printed[arch] = out.getvalue().splitlines()
        assert len(run["outputs"]) == 2 and len(printed[arch]) == 2, printed[arch]
        for ln in printed[arch]:
            log(f"launcher {arch}: {ln[:120]}")
    lap("g launcher")
    res.update(laps_s=laps, path_s=time.perf_counter() - t_phase,
               card_memory_bytes=torch.cuda.get_device_properties(dev).total_memory)
    for name in ("dbrx", "jamba"):
        r = res[name]
        log(f"moe/hybrid serving {name}: {r['params']} parameters; {json.dumps(r['ms'])}; "
            f"bounds {json.dumps(r['bounds_ms'])}; drop fraction by MoE layer {r['moe_drop_fraction']}")
        log(f"moe/hybrid serving {name}: generate {json.dumps(r['generate'])}; decode vs prefill "
            f"{json.dumps(r['decode_vs_prefill'])}; bf16 vs f32 {json.dumps(r['bf16_vs_f32'])}")
        log(f"moe/hybrid serving {name}: peak memory {r['peak_memory_bytes']} bytes; traced "
            f"{json.dumps(r['traced'])}; generate's idle share from them {r['generate_idle_share_derived']:.3f}")
    log(f"moe/hybrid serving: calibrate {json.dumps(res['dbrx']['calibrate'])}; its kernels "
        f"{json.dumps(res['dbrx']['calibrate_kernels'])}")
    log(f"moe/hybrid serving: smoke card vs CPU {json.dumps(res['smoke_card_vs_cpu'])}; train step "
        f"{json.dumps(res['train_card_vs_cpu'])}; phase {res['path_s']:.1f} s, by step {json.dumps(laps)}")
    return launches, res


# ----------------------------------------------------------------- phase 13

# phase 13's tolerances: phase 10's and phase 11a's for whisper and pixtral
# (dense attention stacks like phase 10's), bfloat16 decode against
# bfloat16 prefill included, as phase 10 holds both to one tolerance.
# For RWKV-6 the reference's own bfloat16 logits sit far from its float32
# ones: 0.16–0.29 rms and 0.52–1.11 max (of the float32 rms) at smoke
# width over its 32 layers, 4 × 64
# (tests/test_torch_models.py::test_bf16_rwkv_at_full_depth_sits_as_far_
# from_float32_as_the_reference: the float32 recurrence reads bfloat16 r,
# k, v and the bfloat16 token-shift mixes, 32 times over), so 1.5× its
# farthest row, as that test holds the port: rms 0.43, max 1.67, for
# bfloat16 decode against bfloat16 prefill too (PERF.md records the
# readings these were set after).
RWKV_BF16_RMS_TOL, RWKV_BF16_MAX_TOL = 0.43, 1.67
# all 40: 1.22e10 float32 parameters (49.0 GB) and a 21.8 GB bfloat16 copy of
# the blocks; at 24 layers a run peaked at 47.97 GB with 44.6 GB of weights
PIXTRAL_REPEATS = 40


def last_families_serving(dev) -> tuple[dict, dict]:
    """Phase 13, the last model families (``models.rwkv``, the whisper
    encoder and cross-attention, the pixtral vision frontend) through
    ``serve.Engine`` and ``launch.serve``, at full width:

    a. RWKV-6-7B at full depth (32 layers, d 4096, 64 heads × 64, d_ff
       14,336, vocab 65,536, chunk 256: the 512-token prefill crosses two
       whole chunks): ``serve_at_width``'s steps, the prefill traced over
       its first 2 layers (the step loop launches some 10^5 kernels a
       prefill); ``calibrate`` of 2 × (2, 512) tokens
       (``calibration_check``);
    b. Whisper-medium at full depth (24 encoder and 24 decoder layers, d
       1024, 1,500 seeded frames, which q_chunk 512 does not divide):
       ``serve_at_width``'s steps with the frames in every prefill and
       forward and zero frames through ``generate``; ``calibrate`` of 2 ×
       (2, 512) tokens with frames;
    c. Pixtral-12B with ``PIXTRAL_REPEATS`` of its 40 layers (d 5120,
       32 heads, 8 kv heads, d_ff 14,336, vocab 131,072):
       ``serve_at_width``'s steps with (4, 1024, 5120) bfloat16 patch
       embeddings ahead of the text in every prefill and forward, text
       only through ``generate``; ``calibrate`` of 2 × (2, 512) tokens with
       1,024 patches each;
    d. the smoke configs of rwkv6-7b, whisper-medium and pixtral-12b,
       card against CPU (``smoke_card_vs_cpu``) and one float32 train step
       each (``train_card_vs_cpu``);
    e. ``launch.serve.main --smoke`` for the three on the card.

    Each model is freed before the next; each one's peak device memory is
    recorded.  The launch counts are those of the three ``calibrate``
    calls.  Returns them and the measurements."""
    import contextlib
    import dataclasses
    import gc
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    t_phase = time.perf_counter()
    res, laps, launches = {}, {}, {}
    rng = np.random.default_rng(SEED + 50)

    def lap(name: str) -> None:  # wall seconds of each step of the phase
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    def fresh() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)

    full = get_config("pixtral-12b")
    models = (
        ("rwkv", get_config("rwkv6-7b"), RWKV_BF16_RMS_TOL, RWKV_BF16_MAX_TOL, 2),
        ("whisper", get_config("whisper-medium"), BF16_RMS_TOL, BF16_MAX_TOL, None),
        ("pixtral", dataclasses.replace(full, repeats=PIXTRAL_REPEATS), BF16_RMS_TOL, BF16_MAX_TOL, None),
    )
    for name, cfg, rms_tol, max_tol, trace_repeats in models:
        fresh()
        with torch.no_grad():
            eng, params, res[name] = serve_at_width(
                dev, cfg, dataclasses.replace(cfg, compute_dtype="float32"), rng, rms_tol, max_tol, trace_repeats,
                step_tol=(rms_tol, max_tol))
        batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int32),
                    **on_card(frontend_inputs(cfg, 2, rng), dev)} for _ in range(2)]
        got, res[name]["calibrate"], res[name]["calibrate_kernels"], cal_ms, fwd_ms = \
            calibration_check(eng, batches, forward_reps=1)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        res[name]["ms"].update(calibrate=cal_ms, calibration_forward=fwd_ms)
        res[name]["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        del eng, params, batches
        lap(name)
        log(f"last families {name}: served and calibrated in {laps[name]:.1f} s")

    fresh()
    archs = ("rwkv6-7b", "whisper-medium", "pixtral-12b")
    res["smoke_card_vs_cpu"] = {a: smoke_card_vs_cpu(dev, a) for a in archs}
    res["train_card_vs_cpu"] = {a: train_card_vs_cpu(dev, a) for a in archs}
    lap("d smoke")

    printed = {}
    for arch in archs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run = launcher.main(["--arch", arch, "--smoke", "--device", str(dev), "--batch", "2",
                                 "--max-new-tokens", "8"])
        printed[arch] = out.getvalue().splitlines()
        assert len(run["outputs"]) == 2 and len(printed[arch]) == 2, printed[arch]
        for ln in printed[arch]:
            log(f"launcher {arch}: {ln[:120]}")
    lap("e launcher")
    res.update(laps_s=laps, path_s=time.perf_counter() - t_phase, pixtral_repeats=PIXTRAL_REPEATS,
               card_memory_bytes=torch.cuda.get_device_properties(dev).total_memory)
    for name, *_ in models:
        r = res[name]
        log(f"last families {name}: {r['params']} parameters; {json.dumps(r['ms'])}; "
            f"bounds {json.dumps(r['bounds_ms'])}")
        log(f"last families {name}: generate {json.dumps(r['generate'])}; decode vs prefill "
            f"{json.dumps(r['decode_vs_prefill'])}; bf16 vs f32 {json.dumps(r['bf16_vs_f32'])}")
        log(f"last families {name}: calibrate {json.dumps(r['calibrate'])}; its kernels "
            f"{json.dumps(r['calibrate_kernels'])}")
        log(f"last families {name}: peak memory {r['peak_memory_bytes']} bytes; traced (prefill over "
            f"{r['traced_prefill_repeats']} repeats) {json.dumps(r['traced'])}; generate's idle share from them "
            f"{r['generate_idle_share_derived']:.3f}")
    log(f"last families: smoke card vs CPU {json.dumps(res['smoke_card_vs_cpu'])}; train step "
        f"{json.dumps(res['train_card_vs_cpu'])}; launches {launches}; phase {res['path_s']:.1f} s, "
        f"by step {json.dumps(laps)}")
    return launches, res


# ----------------------------------------------------------------- phase 14

# phase 14's tolerance, set before its first run: the dry-run's predicted
# peak (the arguments plus the meta pass's largest live set) against
# ``torch.cuda.max_memory_allocated`` over the arguments' allocation and one
# real step, within 10 % of the prediction plus 256 MiB (cuBLAS workspaces,
# the caching allocator's rounding); a miss is printed, not a failure.
PEAK_TOL_REL, PEAK_TOL_ABS = 0.10, 256 << 20
# (arch, kind, seq, batch): phase 11's training shape and phase 10's prefill
DRYRUN_CELLS = (("smollm-135m", "train", TRAIN_SEQ, TRAIN_BATCH), ("qwen3-8b", "prefill", 512, 4))
CORE_N, CORE_T = 1 << 22, 40 * 254  # dryrun_core's defaults: N = 2^30 over 256 devices, T = 40 β
# phase 14d's tolerance, set before its first run: each example's card
# printout against its CPU run, line by line.  The words and every count and
# histogram number equal (the kernels are held bit-equal to their plain
# versions); the example's CLOCK_FIELDS dropped; its MODEL_FIELDS (float32
# model arithmetic whose reduction orders differ) within phase 11's clip
# threshold tolerance, rel 1e-4, plus one unit of the last printed digit.
EXAMPLE_MODEL_TOL = TRAIN_THR_TOL
# train_lm's Trainer draws its parameters from a generator on its own device
# (Philox on the card, the Mersenne twister on the CPU), so its MODEL_FIELDS
# differ by the draw, not by rounding: they are dropped there (phase 11a holds
# a train step card against CPU on one set of parameters)
DRAWN_ON_DEVICE = ("train_lm",)


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under a tree of tensors."""
    from repro_torch.tree import leaves

    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in leaves(tree)}.values())


def dryrun_cell_on_card(dev, arch: str, kind: str, S: int, B: int) -> dict:
    """Phase 14a–b for one cell on a 1 × 1 stand-in mesh: the dry-run's
    record, then the cell's arguments materialized on the card (their bytes
    equal to the predicted ``argument_size_in_bytes``, group by group), one
    real step's peak memory beside the predicted peak, and its time beside
    ``roofline_step_s`` and this script's own bound."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import init_cache, init_model, prefill
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import make_opt_state, make_train_step

    cfg = get_config(arch)
    shape = ShapeConfig(f"{kind}_{B}x{S}", S, B, kind)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, False, mesh=dryrun.StandInMesh(("data", "model"), (1, 1)))
    dry_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED + 14), device=dev)
    rng = np.random.default_rng(SEED + 14)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    if kind == "train":
        opt = dataclasses.replace(OptimizerConfig(), moment_dtype=cfg.optimizer_dtype, clip_mode="global_norm")
        state = make_opt_state(params, opt)
        batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1),
                 "mask": torch.ones((B, S), dtype=torch.float32, device=dev)}
        args = {"params": params, "opt": state, "batch": batch}
        step = make_train_step(cfg, opt)

        def run():
            return step(params, state, batch)

        bound = train_bound_ms(cfg, B, S)["ms"]
    else:
        cache = init_cache(cfg, B, S, device=dev)
        batch = {"tokens": tokens}
        args = {"params": params, "batch": batch, "cache": cache}

        def run():
            return prefill(cfg, params, batch, cache)

        bound = stack_bounds_ms(cfg, params["blocks"], B, S, S, 0.0)["prefill"]
    got = {name: storage_bytes(tree) for name, tree in args.items()}
    want = rec["memory"]["arguments_by_group"]
    assert got == want and sum(got.values()) == rec["memory"]["argument_size_in_bytes"], (arch, got, want)
    out = run()
    torch.cuda.synchronize()
    del out
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms = cuda_ms(run, reps=3)
    predicted = rec["memory"]["peak_bytes_per_device"]
    res = {
        "arch": arch, "shape": shape.name, "dryrun_s": dry_s, "argument_bytes": sum(got.values()),
        "arguments_equal": True, "predicted_peak_bytes": predicted, "max_memory_allocated": peak,
        "peak_within_tolerance": abs(peak - predicted) <= PEAK_TOL_REL * predicted + PEAK_TOL_ABS,
        "roofline_step_ms": rec["roofline_step_s"] * 1e3, "terms_ms": {k: v * 1e3 for k, v in rec["terms"].items()},
        "dominant": rec["dominant"], "measured_ms": ms, "chip_smoke_bound_ms": bound,
        "flops_by_dtype": rec["flops_by_dtype"], "bytes": rec["hlo_bytes_per_device"],
    }
    del params, args, batch, run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"dry run {arch} {shape.name} (1 x 1): arguments {res['argument_bytes']} B allocated = predicted; peak "
        f"{peak / 1e9:.3f} GB against predicted {predicted / 1e9:.3f} GB "
        f"({'within' if res['peak_within_tolerance'] else 'MISSED'} 10 % + 256 MiB); step {ms:.3f} ms against "
        f"roofline_step_s {res['roofline_step_ms']:.3f} ms ({rec['dominant']}) and this script's bound "
        f"{bound:.3f} ms; dry run {dry_s:.1f} s")
    return res


def dryrun_core_on_card(dev) -> tuple[dict, dict]:
    """Phase 14c: ``dryrun_core``'s ``merge`` at one device's share
    (N/256 = 2^22 values, T = 40·254, β = 254) through
    ``distributed_histogram`` on an NCCL group of one rank: the predicted
    kernel bound beside the measured ms; the result bit-equal to the
    world-1 composition run on the CPU (the plain versions).  Returns the
    launches of one call and the measurements."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import distributed_histogram
    from repro_torch.launch import dryrun, dryrun_core
    from repro_torch.launch.mesh import make_mesh

    rec = dryrun_core.run("merge", False, CORE_N, CORE_T, BETA, mesh=dryrun.StandInMesh(("data",), (1,)))
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    x = -torch.log(torch.empty(CORE_N, device=dev).exponential_(generator=g).clamp_(
        min=torch.finfo(torch.float32).tiny))
    root = tempfile.mkdtemp(prefix="nccl-", dir=os.path.join(ROOT, "build"))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        distributed_histogram(x, CORE_T, BETA, mesh)  # NCCL makes its communicator at the first collective
        torch.cuda.synchronize()
        kernels.reset_launches()
        h, ms_one, wall = event_call(lambda: distributed_histogram(x, CORE_T, BETA, mesh))
        launches = kernels.reset_launches()
        ms = cuda_ms(lambda: distributed_histogram(x, CORE_T, BETA, mesh), reps=10)
        from repro_torch.core import build_exact

        want = world_1(build_exact(x.cpu(), CORE_T), BETA)  # the plain versions
        assert same_hist(h, want), "dryrun_core merge: not the world-1 composition on the CPU"
        assert float(h.sizes.double().sum()) == CORE_N
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    for name in ("tile_sort", "merge_cut"):
        assert launches[name] > 0, f"dryrun_core merge never launched {name}: {launches}"
    res = {"variant": "merge", "n": CORE_N, "T": CORE_T, "beta": BETA, "measured_ms": ms, "first_call_ms": ms_one,
           "first_call_wall_ms": wall, "predicted_kernel_bound_ms": rec["kernel_bound_s"] * 1e3,
           "predicted_roofline_ms": rec["roofline_step_s"] * 1e3,
           "launch_bounds_ms": {f"{i['name']} {i['shape']}": i["bound_s"] * 1e3 for i in rec["launches"]}}
    log(f"dryrun_core merge, 2^22 values at world 1: {ms:.4f} ms a call (first {ms_one:.4f} ms, wall {wall:.3f} ms) "
        f"against the predicted kernel bound {res['predicted_kernel_bound_ms']:.4f} ms; launches {launches}")
    return launches, res


def same_printout(name: str, example, card_out: str, cpu_out: str) -> float:
    """Hold an example's card printout to its CPU run, line by line, within
    phase 14d's tolerance.  Returns the largest relative gap of its
    ``MODEL_FIELDS`` (0 where ``DRAWN_ON_DEVICE`` drops them)."""
    from repro_torch.examples import split_fields

    lines, values = [], []
    for out in (card_out, cpu_out):
        text = split_fields(out, example.CLOCK_FIELDS)[0]
        text, nums = split_fields(text, example.MODEL_FIELDS)
        lines.append(text.splitlines())
        values.append(nums)
    diff = [(a, b) for a, b in zip(*lines) if a != b]
    assert lines[0] == lines[1], (name, len(lines[0]), len(lines[1]), diff[:3])
    worst = 0.0
    for a, b in zip(*values) if name not in DRAWN_ON_DEVICE else ():
        unit = 10.0 ** -len(b.partition(".")[2])  # one unit of the last printed digit
        gap = abs(float(a) - float(b))
        assert gap <= EXAMPLE_MODEL_TOL * abs(float(b)) + unit, (name, a, b)
        worst = max(worst, gap / max(abs(float(b)), unit))
    return worst


def quickstart_shapes_vs_plain(dev) -> None:
    """The quickstart's kernel calls at its own shapes and on its own draws
    — 16 row sorts of 1 × 65,536 into 10,160 buckets, their merge into
    254, the bucket count of 2^20 values against 255 boundaries — on the
    card, bit-equal to the plain versions."""
    import torch

    from repro_torch.core import build_exact, merge_list
    from repro_torch.kernels import bucket_sizes

    rng = np.random.default_rng(0)
    parts = [rng.gumbel(size=65_536).astype(np.float32) for _ in range(16)]
    hs = {d: [build_exact(p, 40 * BETA, device=d) for p in parts] for d in (dev, "cpu")}
    assert all(same_hist(a, b) for a, b in zip(*hs.values())), "quickstart's row sorts"
    merged = {d: merge_list(h, BETA) for d, h in hs.items()}
    assert same_hist(*merged.values()), "quickstart's merge"
    values = np.concatenate(parts)
    counts = {d: bucket_sizes(values, merged[d].boundaries, device=d).cpu() for d in (dev, "cpu")}
    assert torch.equal(*counts.values()), "quickstart's bucket count"


def examples_on_card(dev) -> tuple[dict, dict]:
    """Phase 14d: each example's ``main`` on the card at its smoke size
    (the train example 4 steps, its checkpoints in ``build/``), each ending
    with its ``... OK``, then again with ``device="cpu"`` (the plain
    versions): the card's printout held to the CPU's line by line, and the
    quickstart's kernel calls held to their plain versions.
    Returns the card runs' launches together and each one's wall seconds,
    last lines and largest model-field gap."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.examples import log_analytics, quickstart, serve_calibrated, train_lm

    ckpt = tempfile.mkdtemp(prefix="train-lm-", dir=os.path.join(ROOT, "build"))
    runs = (("quickstart", quickstart, lambda d: quickstart.main(device=d)),
            ("log_analytics", log_analytics, lambda d: log_analytics.main(True, device=d)),
            ("serve_calibrated", serve_calibrated, lambda d: serve_calibrated.main(device=d)),
            ("train_lm", train_lm, lambda d: train_lm.main(
                ["--steps", "4", "--compress", "--ckpt-dir", os.path.join(ckpt, d or "card")]
                + (["--device", d] if d else []))))

    def printout(fn, device) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(device)
        return buf.getvalue()

    res, card_out = {}, {}
    kernels.reset_launches()
    try:
        for name, _, fn in runs:
            t0 = time.perf_counter()
            card_out[name] = printout(fn, None)
            lines = card_out[name].splitlines()
            assert lines and lines[-1] == f"{name} OK", (name, lines[-3:])
            res[name] = {"s": time.perf_counter() - t0, "lines": len(lines), "last": lines[-3:]}
        launches = kernels.reset_launches()
        quickstart_shapes_vs_plain(dev)
        for name, example, fn in runs:
            t0 = time.perf_counter()
            res[name]["model_fields_rel_gap"] = same_printout(name, example, card_out[name], printout(fn, "cpu"))
            res[name]["cpu_s"] = time.perf_counter() - t0
            held = ("model fields dropped: drawn on each device" if name in DRAWN_ON_DEVICE
                    else f"model fields within rel {res[name]['model_fields_rel_gap']:.2e}")
            log(f"example {name} on the card: {res[name]['s']:.1f} s, {res[name]['lines']} lines equal to the "
                f"CPU run's ({held}), ends {res[name]['last'][-2:]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for name in PATH_KERNELS:
        assert launches[name] > 0, f"the examples never launched {name}: {launches}"
    return launches, res


def dryrun_against_the_card(dev) -> tuple[tuple[dict, dict], dict]:
    """Phase 14: the dry-run held to the card (module docstring).  Returns
    the launches of the dryrun_core check and of the examples, and the
    measurements."""
    t_phase = time.perf_counter()
    cells = [dryrun_cell_on_card(dev, *cell) for cell in DRYRUN_CELLS]
    core_launches, core = dryrun_core_on_card(dev)
    ex_launches, examples = examples_on_card(dev)
    return (core_launches, ex_launches), {"cells": cells, "core": core, "examples": examples,
                                          "path_s": time.perf_counter() - t_phase}


MERGE_SHAPES_FILE = os.path.join(ROOT, "build", "merge_shapes.json")


def save_merge_shapes(dev, seen: dict) -> list[dict]:
    """Write the main path's merge shapes to ``build/merge_shapes.json``
    (``scripts/merge_sweep.py`` reads them) and time each."""
    os.makedirs(os.path.dirname(MERGE_SHAPES_FILE), exist_ok=True)
    with open(MERGE_SHAPES_FILE, "w") as f:
        json.dump([[*key, calls] for key, calls in sorted(seen.items())], f)
    log(f"merge shapes of phases 3-6 and 8-14: {len(seen)} distinct, {sum(seen.values())} calls")
    return merge_shape_times(dev, seen)


def ptxas_summary(text: str) -> list[str]:
    """``name: registers, spill bytes`` of each kernel in ``-Xptxas -v``
    output (names mangled, cut to 60 characters)."""
    out, name, spill = [], None, "?"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)[:60]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs {spill} spill")
            name = None
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
    from repro_torch import kernels
    from repro_torch.kernels import _lib

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
            log(f"{src}: " + "; ".join(ptxas_summary(f.read())))
    meas = phase("2 kernels vs plain", lambda: check_kernels(dev, rng))
    sorts = phase("2b sort sweep", lambda: sort_sweep(dev))
    counts = phase("2c bucket count shapes", lambda: bucket_count_shapes(dev))
    decode = phase("2d decode attention", lambda: decode_attention_shape(dev))
    with MergeShapes() as shapes:
        main_path = phase("3 paper config", lambda: paper_config(dev))
        big = phase("4 scale", lambda: scale(dev))
        logs = phase("5 log analytics", lambda: log_analytics(dev))
        tenants = phase("6 registry", lambda: registry(dev))
        serving = phase("8 service", lambda: service(dev))
        plane = phase("9 distributed", lambda: distributed_plane(dev))
        models = phase("10 model serving", lambda: model_serving(dev))
        training_ = phase("11 training", lambda: training(dev))
        moe_hybrid = phase("12 moe and hybrid serving", lambda: moe_hybrid_serving(dev))
        last = phase("13 rwkv, whisper and pixtral serving", lambda: last_families_serving(dev))
        dry = phase("14 dry run against the card", lambda: dryrun_against_the_card(dev))
    merges = phase("7 merge shapes", lambda: save_merge_shapes(dev, shapes.seen))
    if failed:
        log(f"chip_smoke: phases failed: {failed}")
        return 1
    launches, times = main_path
    meas["bucket_count"] = big.pop("bucket_count")
    per_path = {"paper": launches, "log_analytics": logs[0], "registry": tenants[0], "service": serving[0],
                "distributed": plane[0], "model_serving": models[0], "training": training_[0],
                "moe_hybrid_serving": moe_hybrid[0], "last_families_serving": last[0], "dryrun": dry[0][0],
                "examples": dry[0][1]}
    total = {name: sum(c[name] for c in per_path.values()) for name in _lib.KERNELS}
    if not all(total.values()):  # every kernel, the kv sort too, on the main paths
        log(f"chip_smoke: a kernel was never launched on the main paths: {per_path}")
        return 1
    replaces = {
        "tile_sort": ("src/repro_torch/kernels/csrc/row_sort.cu", "src/repro/kernels/tile_sort.py:119"),
        "sort_kv": ("src/repro_torch/kernels/csrc/kv_sort.cu", "src/repro/kernels/tile_sort.py:125"),
        "merge_cut": ("src/repro_torch/kernels/csrc/merge_cut.cu", "src/repro/kernels/merge_cut.py:46"),
        "bucket_count": ("src/repro_torch/kernels/csrc/bucket_count.cu", "src/repro/kernels/bucket_count.py:35"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0], "replaces": replaces[name][1],
         "launches": total[name], **meas[name]}
        for name in replaces
    ] + [{"name": "decode_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
          "replaces": None, "launches": total["decode_attention"], **decode}]}
    log(json.dumps(line))
    log(json.dumps({"build_s": build_s, "launches_by_path": per_path, "merge_split": meas["merge_split"],
                    "paper": times, "scale": big,
                    "log_analytics": logs[1], "registry": tenants[1], "service": serving[1], "distributed": plane[1],
                    "model_serving": models[1], "training": training_[1], "moe_hybrid_serving": moe_hybrid[1],
                    "last_families_serving": last[1], "dryrun": dry[1],
                    "sorts": sorts,
                    "bucket_count_shapes": counts, "merge_shapes": merges}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
