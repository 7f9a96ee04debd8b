"""The card's figures, and the device-memory bytes and the operations of
each kernel call.

The least work a call of each kernel must do, computed from its shapes:
each input read once and each output written once, and the comparisons
of a comparison sort (n·log2 n a row) or of a binary search (log2 of
the boundaries a value).  Each ``*_cost`` function returns ``(bytes,
operations)``; :func:`bound_s` turns a pair into the least time on the
card.  ``chip_smoke.py`` holds each timed kernel to it,
``launch.dryrun_core`` prices the paper's technique with it, and
``launch.dryrun`` prices whole steps with the same figures.
"""
from __future__ import annotations

import math

__all__ = [
    "CARD", "F32_FLOPS", "HBM_BW", "HBM_BYTES", "NETWORK_BW", "NODE_GPUS", "NVLINK_BW", "PEAK_FLOPS",
    "bound_s", "bucket_count_cost", "decode_attention_cost", "kv_sort_cost", "merge_bytes", "merge_cost",
    "row_sort_cost",
]

# ---- hardware constants (one NVIDIA H100 SXM 80 GB, 700 W) -----------------
CARD = "NVIDIA H100 SXM 80GB"
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (NVIDIA H100 SXM data sheet)
F32_FLOPS = 67e12  # float32 FLOP/s outside the tensor cores (same sheet)
HBM_BW = 3.35e12  # device-memory bytes/s (same sheet)
HBM_BYTES = 80e9  # device memory (same sheet)
NVLINK_BW = 450e9  # bytes/s a direction a GPU within a node of 8 (NVLink 4: 900 GB/s both ways)
NETWORK_BW = 50e9  # bytes/s a GPU across nodes: a DGX H100 has one 400 Gb/s ConnectX-7 port a GPU
NODE_GPUS = 8


def bound_s(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """The least time for work that moves ``nbytes`` of device memory and
    does ``ops`` float32 operations: the larger of the two times, and which
    bounds it (``"bytes"`` or ``"operations"``)."""
    tb, to = nbytes / HBM_BW, ops / F32_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def row_sort_cost(rows: int, n: int, T: int) -> tuple[float, float]:
    """``summarize_rows`` of ``rows`` rows of ``n`` 4-byte values into T
    buckets: the rows read once, the T + 1 cuts a row written once."""
    return 4.0 * rows * n + 4.0 * rows * (T + 1), rows * n * math.log2(max(n, 2))


def kv_sort_cost(Q: int, L: int) -> tuple[float, float]:
    """``sort_kv`` of Q rows of L (4-byte key, 4-byte value) pairs: read
    once and written once."""
    return 16.0 * Q * L, Q * L * math.log2(max(L, 2))


def merge_bytes(Q: int, k: int, T1: int, beta: int) -> float:
    """Device-memory bytes a merge call must move: the boundaries and sizes
    read once, the β+1 boundaries and β sizes written once."""
    return 4.0 * Q * (k * T1 + k * (T1 - 1) + 2 * beta + 1)


def merge_cost(Q: int, k: int, T1: int, beta: int) -> tuple[float, float]:
    """``merge_batched`` of Q problems of k summaries of T1 boundaries into
    β buckets: :func:`merge_bytes`, and a sort of the k·T1 boundaries a
    problem."""
    L = k * T1
    return merge_bytes(Q, k, T1, beta), Q * L * math.log2(max(L, 2))


def bucket_count_cost(N: int, T1: int) -> tuple[float, float]:
    """``cumulative_counts`` of N 4-byte values against T1 boundaries: the
    values read once, a binary search each."""
    return 4.0 * N, N * math.log2(max(T1, 2))


def decode_attention_cost(B: int, Hkv: int, G: int, hd: int, n: int, kv_bytes: int, q_bytes: int) -> tuple[float, float]:
    """The decode attention of B rows of Hkv KV heads, G query heads each,
    against n visible cache positions of hd ``kv_bytes`` elements: K and V
    of the visible positions read once, q read and the output written once;
    2·hd operations a (query head, position) for the score and 2·hd for the
    PV product."""
    heads = B * Hkv
    return 2.0 * heads * n * hd * kv_bytes + 2.0 * heads * G * hd * q_bytes, 4.0 * heads * G * n * hd
