"""Row sort (the Summarizer) and stable kv sort: wrappers of the CUDA
kernels in ``csrc/row_sort.cu`` and ``csrc/kv_sort.cu``.

Replace ``tile_sort_kernel`` and ``tile_sort_kv_kernel`` of
``repro/kernels/tile_sort.py`` (networks ``_bitonic``/``_bitonic_kv``).
The TPU kernels sort one VMEM tile; these sort rows of any length exactly,
with the wide network stages run over device memory (``csrc/bitonic.cuh``
says how, and why the bound is device-memory bytes).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib, ref

__all__ = ["argsort_pairs", "sort_rows", "summarize_rows", "sort_kv"]


def _next_pow2(k: int) -> int:
    return 1 << max(0, k - 1).bit_length()


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel takes CUDA tensors, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("kernel inputs lie on different devices")


def _check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"rows must be a non-empty (rows, n) tensor, got {tuple(x.shape)}")
    if x.shape[1] > 1 << 30:
        raise ValueError("rows longer than 2^30 are not supported")


def _sorted_keys(x: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """Launch the row sort; returns the (rows, next_pow2(n)) key buffer."""
    _check_cuda(x)
    _check_rows(x)
    code = _lib.dtype_code(x)
    rows, width = x.shape
    n = _next_pow2(width)
    keys = torch.empty((rows, n), dtype=torch.int32, device=x.device)
    lib = _lib.library("tile_sort")
    err = lib.hk_row_sort(
        x.data_ptr(), keys.data_ptr(), rows, width, n, code,
        None if out is None else out.data_ptr(), _lib.stream(x),
    )
    _lib.check(lib, err, "row sort")
    _lib.count("tile_sort")
    return keys


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of each row of a ``(rows, n)`` float32/int32 tensor.

    Same order as ``torch.sort``: NaN last, and -0/+0 tie (the kernel
    writes both as +0, and every NaN as one NaN)."""
    if x.device.type == "cpu":
        return ref.sort_rows_ref(x)
    out = torch.empty_like(x)
    _sorted_keys(x, out)
    return out


def summarize_rows(x: torch.Tensor, ns, num_buckets: int) -> torch.Tensor:
    """Summarizer boundaries: sort each row of ``x (rows, width)`` and read
    ``(rows, T+1)`` values at the masked cuts ``min(floor(i·n/T), n-1)``,
    ``n = ns[row]`` (host integers, ``1 <= n <= width``)."""
    ns = np.asarray(ns, np.int64).reshape(-1)
    if ns.shape[0] != x.shape[0] or ns.min() < 1 or ns.max() > x.shape[1]:
        raise ValueError("need one true length 1 <= n <= width per row")
    if num_buckets < 1:
        raise ValueError("num_buckets must be >= 1")
    if x.device.type == "cpu":
        return ref.summarize_rows_ref(x, ns, num_buckets)
    keys = _sorted_keys(x, None)
    rows, n = keys.shape
    ns_dev = torch.as_tensor(ns.astype(np.int32)).to(x.device)
    out = torch.empty((rows, num_buckets + 1), dtype=x.dtype, device=x.device)
    lib = _lib.library("tile_sort")
    err = lib.hk_row_gather(
        keys.data_ptr(), ns_dev.data_ptr(), rows, n, num_buckets,
        _lib.dtype_code(x), out.data_ptr(), _lib.stream(x),
    )
    _lib.check(lib, err, "row gather")
    return out


def argsort_pairs(keys: torch.Tensor, L: int) -> torch.Tensor:
    """Stable row-wise argsort of ``keys (rows, l_real)`` (CUDA, float32 or
    int32) as sorted 64-bit pairs ``(key << 32) | index``, ``(rows, L)``
    with ``L`` a power of two ``>= l_real``; the positions past ``l_real``
    sort last.  The shared first stage of :func:`sort_kv` and the merge."""
    _check_cuda(keys)
    _check_rows(keys)
    rows, lreal = keys.shape
    if L < lreal or L & (L - 1):
        raise ValueError("L must be a power of two >= the row length")
    order = torch.empty((rows, L), dtype=torch.int64, device=keys.device)
    lib = _lib.library("sort_kv")
    err = lib.hk_argsort(
        keys.data_ptr(), order.data_ptr(), rows, lreal, L,
        _lib.dtype_code(keys), _lib.stream(keys),
    )
    _lib.check(lib, err, "kv sort")
    _lib.count("sort_kv")
    return order


def sort_kv(keys: torch.Tensor, vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable key/value sort of ``(rows, L)`` pairs: exactly
    ``argsort(keys, stable=True)`` applied to both (lexicographic on
    ``(key, original index)``, as ``_bitonic_kv``)."""
    if keys.shape != vals.shape:
        raise ValueError("keys and values must have one shape")
    if keys.device.type == "cpu":
        return ref.sort_kv_ref(keys, vals)
    _check_cuda(keys, vals)
    _lib.dtype_code(vals)  # any 4-byte payload the kernel can carry
    rows, L = keys.shape
    order = argsort_pairs(keys, _next_pow2(L))
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    lib = _lib.library("sort_kv")
    err = lib.hk_kv_gather(
        order.data_ptr(), keys.data_ptr(), vals.data_ptr(), rows, L,
        order.shape[1], ko.data_ptr(), vo.data_ptr(), _lib.stream(keys),
    )
    _lib.check(lib, err, "kv gather")
    return ko, vo
