"""Batched histogram merge (paper Algorithm 1): wrapper of the CUDA kernels
in ``csrc/merge_cut.cu``.

Replaces ``merge_cut_kernel`` of ``repro/kernels/merge_cut.py`` (wrapper
``merge_pallas``).  One call merges a batch of Q problems of ``k`` stacked
``T``-bucket summaries each into β buckets, in one of two regimes
(:func:`plan`):

- **resident** (``k(T+1) <= tile_sort.KV_RESIDENT_LIMIT``): one launch;
  one block a problem sorts, scans and cuts in shared memory;
- **long**: :func:`~repro_torch.kernels.tile_sort.argsort_pairs` sorts,
  then one scan-and-cut launch reads its pairs once and keeps only a
  total per group of keys.

The source note in ``csrc/merge_cut.cu`` gives each regime's byte bound.
A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref, tile_sort
from repro_torch.kernels.tile_sort import _check_cuda, _next_pow2, _ptr, argsort_pairs

__all__ = ["merge_batched", "plan"]


def plan(k: int, T: int, regime: str | None = None) -> int:
    """The resident capacity a merge of ``k`` summaries of ``T`` buckets
    runs at, or 0 for the long regime.  ``regime`` forces ``"long"``, or
    demands ``"resident"`` (raises if the problem does not fit); ``None``
    stays resident as far as the resident kv sort does."""
    if regime not in (None, "resident", "long"):
        raise ValueError(f"regime must be 'resident', 'long' or None, not {regime!r}")
    return tile_sort.plan(k * (T + 1), True, "onesweep" if regime == "long" else regime)


def merge_batched(
    bounds: torch.Tensor, sizes: torch.Tensor, beta: int, *, regime: str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``bounds (Q, k, T+1)``/``sizes (Q, k, T)`` into
    ``(Q, β+1)``/``(Q, β)`` — ``repro.core.histogram.merge`` per problem.

    The kernel takes float32 or int32 boundaries (the output keeps their
    dtype and bits) and float32 sizes; β >= 1.  ``regime`` forces a kernel
    path for measurement (:func:`plan`)."""
    if bounds.dim() != 3 or sizes.dim() != 3:
        raise ValueError("merge takes (Q, k, T+1) boundaries and (Q, k, T) sizes")
    Q, k, T1 = bounds.shape
    if tuple(sizes.shape) != (Q, k, T1 - 1) or T1 < 2 or Q < 1 or k < 1:
        raise ValueError(
            f"shapes {tuple(bounds.shape)} / {tuple(sizes.shape)} are not (Q, k, T+1) / (Q, k, T)"
        )
    beta = int(beta)
    if beta < 1:
        raise ValueError("beta must be >= 1")
    cap = plan(k, T1 - 1, regime)
    if bounds.device.type == "cpu" and sizes.device.type == "cpu":
        return ref.merge_ref(bounds, sizes, beta)
    _check_cuda(bounds, sizes)
    if sizes.dtype != torch.float32:
        raise TypeError(f"merge kernel takes float32 sizes, not {sizes.dtype}")
    code = _lib.dtype_code(bounds)
    lreal = k * T1
    if lreal >= 1 << 31:
        raise ValueError("a merge problem must hold fewer than 2^31 boundaries")
    L = _next_pow2(lreal)
    order = None if cap else argsort_pairs(bounds.reshape(Q, lreal), L)
    bo = torch.empty((Q, beta + 1), dtype=bounds.dtype, device=bounds.device)
    so = torch.empty((Q, beta), dtype=torch.float32, device=bounds.device)
    lib = _lib.library("merge_cut")
    err = lib.hk_merge_cut(
        _ptr(order), bounds.data_ptr(), sizes.data_ptr(),
        Q, k, T1 - 1, L, beta, code, cap, bo.data_ptr(), so.data_ptr(), _lib.stream(bounds),
    )
    _lib.check(lib, err, "merge")
    _lib.count("merge_cut")
    return bo, so
