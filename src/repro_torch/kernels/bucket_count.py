"""Bucket count against fixed boundaries: wrapper of the CUDA kernel in
``csrc/bucket_count.cu``.

Replaces ``bucket_count_kernel`` of ``repro/kernels/bucket_count.py``
(wrapper ``cumulative_counts_pallas``).  The TPU kernel compares each tile
of the stream with every boundary (n·(T+1) compares); the CUDA kernel does
one binary search per value and keeps integer counts, and the source note
in ``csrc/bucket_count.cu`` says why the bound is device-memory bytes.

Two differences from the reference, both on purpose:

- the stream is never padded, so nothing but the real values is counted.
  ``cumulative_counts_pallas`` pads with ``+inf`` and counts the padding
  whenever ``b_T = +inf``; its own oracle ``cumulative_counts_ref`` does
  not, and the port follows the oracle;
- the boundaries must be histogram boundaries — non-decreasing, with NaN
  only at the end — because the kernel searches them.  Anything else is
  rejected with a ``ValueError`` (the reference accepts any vector).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import as_tensor, home
from repro_torch.kernels import _lib, ref
from repro_torch.kernels.tile_sort import _check_cuda

__all__ = ["counts", "cumulative_counts"]


def counts(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Exact int64 ``(T+2,)`` counts ``[#(x < b_j)]_{j<=T} ++ [#(x == b_T)]``
    of the float32 values of ``x`` (any shape; other dtypes are cast to
    float32 first, as the reference casts them).  The boundaries
    ``(T+1,)`` follow ``x`` to its device."""
    flat = x.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    b = boundaries.reshape(-1).to(device=flat.device, dtype=torch.float32)
    if b.shape[0] < 2:
        raise ValueError("need at least two boundaries (T >= 1)")
    if flat.device.type == "cpu":
        return ref.counts_ref(flat, b)
    m = ref.count_prefix(b.cpu().numpy())
    flat, b = flat.contiguous(), b.contiguous()
    _check_cuda(flat, b)
    T1 = b.shape[0]
    hist = torch.empty(m + 2, dtype=torch.int64, device=flat.device)
    out = torch.empty(T1 + 1, dtype=torch.int64, device=flat.device)
    sms = torch.cuda.get_device_properties(flat.device).multi_processor_count
    lib = _lib.library("bucket_count")
    err = lib.hk_bucket_count(
        flat.data_ptr(), flat.shape[0], b.data_ptr(), T1, m,
        hist.data_ptr(), out.data_ptr(), sms, _lib.stream(flat),
    )
    _lib.check(lib, err, "bucket count")
    _lib.count("bucket_count")
    return out


def cumulative_counts(x, boundaries, *, device=None) -> torch.Tensor:
    """Cumulative ``< b_j`` counts of ``x`` (any shape) + the ``== b_T``
    count, float32 ``(T+2,)`` — ``cumulative_counts_pallas`` without its
    padding count (module docstring).  Input that is not a tensor goes to
    ``device`` (``None`` → the card)."""
    x = as_tensor(x, home(x, boundaries, device=device))
    return counts(x, as_tensor(boundaries, x.device)).to(torch.float32)
