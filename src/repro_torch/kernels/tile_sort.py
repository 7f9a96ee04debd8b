"""Row sort (the Summarizer) and stable kv sort: wrappers of the CUDA
kernels in ``csrc/row_sort.cu`` and ``csrc/kv_sort.cu``.

Replace ``tile_sort_kernel`` and ``tile_sort_kv_kernel`` of
``repro/kernels/tile_sort.py`` (networks ``_bitonic``/``_bitonic_kv``).
The TPU kernels sort one VMEM tile; these sort rows of any length exactly,
by a stable LSD radix sort of the 32-bit order-preserving key, four passes
of 8-bit digits (``csrc/radix_sort.cuh`` says how, and why the bound is
device-memory bytes).  A row of at most :data:`ROW_RESIDENT_LIMIT` keys
(:data:`KV_RESIDENT_LIMIT` key/index pairs) is sorted by one block in
shared memory; a longer one by the onesweep launches (one histogram, one
scan, four scatters), whose scratch the wrapper allocates
(:func:`plan`).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib, ref

__all__ = [
    "KV_RESIDENT_LIMIT",
    "RESIDENT_CAPS",
    "ROW_RESIDENT_LIMIT",
    "argsort_pairs",
    "onesweep_scratch_words",
    "pad_to_tiles",
    "plan",
    "sort_kv",
    "sort_rows",
    "summarize_rows",
]

# the resident kernels' capacities (keys a row may hold), as launch_resident
# in csrc/radix_sort.cuh instantiates them
RESIDENT_CAPS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# the widest row that stays resident: the largest capacity (key/index pairs
# take 8 bytes of shared memory, keys 4).  Resident beat onesweep at every
# width both could sort in chip_smoke.py's crossover sweep (PERF.md).
ROW_RESIDENT_LIMIT = 32768
KV_RESIDENT_LIMIT = 16384
# keys per onesweep tile (hk::kLongTile)
LONG_TILE = 8192

# what the last pass writes (hk::kKeys, kValues, kPairs, kGather)
_KEYS, _VALUES, _PAIRS, _GATHER = 0, 1, 2, 3


def plan(width: int, kv: bool, regime: str | None = None) -> int:
    """The resident capacity a row of ``width`` keys is sorted in, or 0 for
    the onesweep launches.  ``regime`` forces ``"onesweep"``, or demands
    ``"resident"`` (raises if no resident block holds the row); ``None``
    stays resident up to the resident limit."""
    if regime not in (None, "resident", "onesweep"):
        raise ValueError(f"regime must be 'resident', 'onesweep' or None, not {regime!r}")
    limit = KV_RESIDENT_LIMIT if kv else ROW_RESIDENT_LIMIT
    cap = next((c for c in RESIDENT_CAPS if width <= c <= limit), 0)
    if regime == "resident" and not cap:
        raise ValueError(f"a row of {width} keys does not fit a resident block")
    return 0 if regime == "onesweep" else cap


def onesweep_scratch_words(rows: int, width: int) -> int:
    """int32 words of zeroed scratch of a onesweep sort: per-row digit
    counts (4 × 256), four tile counters, and four passes of one look-back
    status word per tile and digit (hk::launch_onesweep's layout)."""
    tiles = rows * -(-width // LONG_TILE)
    return rows * 1024 + 4 + 4 * tiles * 256


def _next_pow2(k: int) -> int:
    return 1 << max(0, k - 1).bit_length()


def pad_to_tiles(flat: torch.Tensor, tile_len: int) -> torch.Tensor:
    """Pad a 1-D tensor up to a whole number of tiles with a +inf sentinel
    (the dtype's maximum for integers), which sorts past every real value:
    a ragged tail becomes one partly real tile whose true length the
    caller masks (``kernels/ops.py``), as the reference's ``pad_to_tiles``."""
    rem = (-flat.shape[0]) % tile_len
    if rem == 0:
        return flat
    if flat.is_floating_point():
        fill = float("inf")
    else:
        fill = torch.iinfo(flat.dtype).max
    pad = torch.full((rem,), fill, dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, pad])


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


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _onesweep_scratch(rows: int, width: int, device) -> torch.Tensor:
    return torch.zeros(onesweep_scratch_words(rows, width), dtype=torch.int32, device=device)


def _row_sort(x: torch.Tensor, out: torch.Tensor, mode: int, regime: str | None) -> None:
    """Launch the row sort of ``x`` into ``out`` (rows, width): encoded keys
    or decoded values."""
    _check_cuda(x, out)
    _check_rows(x)
    code = _lib.dtype_code(x)
    rows, width = x.shape
    cap = plan(width, False, regime)
    tmp = scratch = None
    if cap == 0:
        tmp = torch.empty((rows, width), dtype=torch.int32, device=x.device)
        scratch = _onesweep_scratch(rows, width, x.device)
    lib = _lib.library("tile_sort")
    err = lib.hk_row_sort(
        x.data_ptr(), out.data_ptr(), mode, rows, width, code, cap,
        _ptr(tmp), _ptr(scratch), _lib.stream(x),
    )
    _lib.check(lib, err, "row sort")
    _lib.count("tile_sort")


def sort_rows(x: torch.Tensor, *, regime: str | None = None) -> torch.Tensor:
    """Ascending sort of each row of a ``(rows, n)`` float32/int32 tensor.

    Same order as ``torch.sort``: NaN last, and -0/+0 tie (the kernel
    writes both as +0, and every NaN as one NaN).  ``regime`` forces a
    kernel path for measurement (:func:`plan`)."""
    if x.device.type == "cpu":
        return ref.sort_rows_ref(x)
    out = torch.empty_like(x)
    _row_sort(x, out, _VALUES, regime)
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
    keys = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _row_sort(x, keys, _KEYS, None)
    rows, width = keys.shape
    # does not wait for the stream: CUDA stages pageable host memory first
    ns_dev = torch.as_tensor(ns.astype(np.int32)).to(x.device, non_blocking=True)
    out = torch.empty((rows, num_buckets + 1), dtype=x.dtype, device=x.device)
    lib = _lib.library("tile_sort")
    err = lib.hk_row_gather(
        keys.data_ptr(), ns_dev.data_ptr(), rows, width, num_buckets,
        _lib.dtype_code(x), out.data_ptr(), _lib.stream(x),
    )
    _lib.check(lib, err, "row gather")
    return out


def _kv_sort(keys, vals, out0, out1, mode: int, stride: int, regime: str | None) -> None:
    """Launch the stable kv sort of ``keys (rows, width)``: pairs into
    ``out0`` (rows, stride), or keys and payload into ``out0``/``out1``."""
    rows, width = keys.shape
    cap = plan(width, True, regime)
    k0 = k1 = i0 = i1 = scratch = None
    if cap == 0:
        k0, i0 = (torch.empty((rows, width), dtype=torch.int32, device=keys.device) for _ in range(2))
        if mode == _GATHER:  # pass 1 writes where pass 3 will
            k1, i1 = out0, out1
        else:
            k1, i1 = (torch.empty_like(k0) for _ in range(2))
        scratch = _onesweep_scratch(rows, width, keys.device)
    lib = _lib.library("sort_kv")
    err = lib.hk_kv_sort(
        keys.data_ptr(), _ptr(vals), out0.data_ptr(), _ptr(out1), mode, rows, width,
        stride, _lib.dtype_code(keys), cap, _ptr(k0), _ptr(k1), _ptr(i0), _ptr(i1),
        _ptr(scratch), _lib.stream(keys),
    )
    _lib.check(lib, err, "kv sort")
    _lib.count("sort_kv")


def argsort_pairs(keys: torch.Tensor, L: int, *, regime: str | None = None) -> torch.Tensor:
    """Stable row-wise argsort of ``keys (rows, l_real)`` (CUDA, float32 or
    int32) as sorted 64-bit pairs ``(key << 32) | index``, ``(rows, L)``
    with ``L`` a power of two ``>= l_real``; the positions ``g`` past
    ``l_real`` hold ``0xFFFFFFFF << 32 | g`` and sort last.  The first
    stage of the merge."""
    _check_cuda(keys)
    _check_rows(keys)
    rows, lreal = keys.shape
    if L < lreal or L & (L - 1):
        raise ValueError("L must be a power of two >= the row length")
    order = torch.empty((rows, L), dtype=torch.int64, device=keys.device)
    _kv_sort(keys, None, order, None, _PAIRS, L, regime)
    return order


def sort_kv(
    keys: torch.Tensor, vals: torch.Tensor, *, regime: str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable key/value sort of ``(rows, L)`` pairs: exactly
    ``argsort(keys, stable=True)`` applied to both (lexicographic on
    ``(key, original index)``, as ``_bitonic_kv``).  The keys keep their
    bits (-0, NaN payloads).  ``regime`` forces a kernel path for
    measurement (:func:`plan`)."""
    if keys.shape != vals.shape:
        raise ValueError("keys and values must have one shape")
    if keys.device.type == "cpu":
        return ref.sort_kv_ref(keys, vals)
    _check_cuda(keys, vals)
    _check_rows(keys)
    _lib.dtype_code(vals)  # any 4-byte payload the kernel can carry
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    _kv_sort(keys, vals, ko, vo, _GATHER, keys.shape[1], regime)
    return ko, vo
