"""Batched histogram merge (paper Algorithm 1): wrapper of the CUDA kernel
in ``csrc/merge_cut.cu``.

Replaces ``merge_cut_kernel`` of ``repro/kernels/merge_cut.py`` (wrapper
``merge_pallas``).  One call merges a batch of Q problems of ``k`` stacked
``T``-bucket summaries each into β buckets: the stable kv sort of
:func:`~repro_torch.kernels.tile_sort.argsort_pairs` orders each problem's
``k(T+1)`` boundaries, then the merge kernel scans the left-collapse masses
and cuts.  The bound is device-memory bytes, dominated by the sort; the
source note in ``csrc/merge_cut.cu`` says why.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.tile_sort import _check_cuda, _next_pow2, argsort_pairs

__all__ = ["merge_batched"]


def merge_batched(
    bounds: torch.Tensor, sizes: torch.Tensor, beta: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``bounds (Q, k, T+1)``/``sizes (Q, k, T)`` into
    ``(Q, β+1)``/``(Q, β)`` — ``repro.core.histogram.merge`` per problem.

    The kernel takes float32 or int32 boundaries (the output keeps their
    dtype) and float32 sizes; β >= 1."""
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
    if bounds.device.type == "cpu" and sizes.device.type == "cpu":
        return ref.merge_ref(bounds, sizes, beta)
    _check_cuda(bounds, sizes)
    if sizes.dtype != torch.float32:
        raise TypeError(f"merge kernel takes float32 sizes, not {sizes.dtype}")
    lreal = k * T1
    if lreal >= 1 << 31:
        raise ValueError("a merge problem must hold fewer than 2^31 boundaries")
    L = _next_pow2(lreal)
    order = argsort_pairs(bounds.reshape(Q, lreal), L)
    cum = torch.empty((Q, L), dtype=torch.float32, device=bounds.device)
    bo = torch.empty((Q, beta + 1), dtype=bounds.dtype, device=bounds.device)
    so = torch.empty((Q, beta), dtype=torch.float32, device=bounds.device)
    lib = _lib.library("merge_cut")
    err = lib.hk_merge_cut(
        order.data_ptr(), bounds.data_ptr(), sizes.data_ptr(), cum.data_ptr(),
        Q, k, T1 - 1, L, beta, bo.data_ptr(), so.data_ptr(), _lib.stream(bounds),
    )
    _lib.check(lib, err, "merge")
    _lib.count("merge_cut")
    return bo, so
