"""Frozen byte counts of the kernels the per-layer rooflines read.

Bytes only, on what the work needs: each real input value read once and
each output written once.  A partition of ``n`` values counts ``n``,
however far the program pads it, and a merge counts the canonical nodes
of its window, however the program packs them.  The program's own
``kernels/cost.py`` may change; this copy is the benchmark's yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB data sheet: device-memory bytes a second
HBM_BYTES_PER_S = 3.35e12


def canonical_nodes(lo: int, hi: int) -> int:
    """Nodes of the canonical segment-tree cover of slots ``[lo, hi]``."""
    count, l, r = 0, lo, hi + 1
    while l < r:
        if l & 1:
            count += 1
            l += 1
        if r & 1:
            r -= 1
            count += 1
        l >>= 1
        r >>= 1
    return count


def row_sort_bytes(n: int, T: int) -> float:
    """Summarize one partition of ``n`` float32 values into ``T`` buckets:
    the values read once, the ``T + 1`` cuts written once."""
    return 4.0 * n + 4.0 * (T + 1)


def merge_bytes(nodes: int, T: int, beta: int) -> float:
    """Merge ``nodes`` summaries of ``T`` buckets into ``beta``: each node's
    ``T + 1`` boundaries and ``T`` sizes read once, ``beta + 1`` boundaries
    and ``beta`` sizes written once."""
    return 4.0 * nodes * (2 * T + 1) + 4.0 * (2 * beta + 1)


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
