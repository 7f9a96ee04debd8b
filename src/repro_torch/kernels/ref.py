"""Plain PyTorch versions of every kernel on the port's path.

Each function is the semantic ground truth its CUDA kernel is held to (on
the card, by ``chip_smoke.py``), and what the kernel wrappers run for a
tensor that lies on the CPU.  Mirrors ``repro.kernels.ref``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bucket_sizes_from_cumulative",
    "count_prefix",
    "counts_ref",
    "cumulative_counts_ref",
    "masked_cuts",
    "sort_rows_ref",
    "summarize_rows_ref",
    "sort_kv_ref",
    "encode_keys",
    "argsort_pairs_ref",
    "merge_ref",
]

# values per searchsorted call of the plain bucket count: bounds its
# scratch (8 bytes a value) whatever the stream's length
_COUNT_CHUNK = 1 << 24


def count_prefix(boundaries: np.ndarray) -> int:
    """How many leading boundaries the bucket count searches: those before
    the first NaN (``x < NaN`` is false, so NaN boundaries count nothing).
    Raises unless that prefix is non-decreasing and only NaN follows it —
    what every histogram's boundaries are (NaN sorts last)."""
    b = np.asarray(boundaries, np.float32).reshape(-1)
    nan = np.isnan(b)
    m = int(np.argmax(nan)) if nan.any() else b.shape[0]
    if not nan[m:].all():
        raise ValueError("boundaries hold NaN before a number: NaN may only end them")
    if np.any(b[1:m] < b[: max(m - 1, 0)]):
        raise ValueError("boundaries must be non-decreasing (histogram boundaries)")
    return m


def counts_ref(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Oracle for the bucket count, in exact integers: int64 ``(T+2,)`` =
    ``[#(x < b_j) for j = 0..T] + [#(x == b_T)]`` over the float32 values
    of ``x`` (any shape).  NaN values are never counted; ``+inf == b_T``
    counts in the last slot.

    Memory-bounded at any length: ``searchsorted`` + ``bincount`` over
    chunks of the stream, then one cumulative sum — not the reference
    oracle's ``(n, T+1)`` comparison.  Needs :func:`count_prefix`-valid
    boundaries (the wrappers check them first)."""
    flat = x.reshape(-1).to(torch.float32)
    b = boundaries.reshape(-1).to(device=flat.device, dtype=torch.float32)
    T1 = b.shape[0]
    m = count_prefix(b.cpu().numpy())
    prefix = b[:m].contiguous()
    hist = torch.zeros(m + 1, dtype=torch.int64, device=flat.device)
    eq = torch.zeros((), dtype=torch.int64, device=flat.device)
    for at in range(0, flat.shape[0] if m else 0, _COUNT_CHUNK):
        v = flat[at : at + _COUNT_CHUNK]
        v = v[~torch.isnan(v)]
        # p = #(b_j <= v) over the sorted prefix, so v < b_j  <=>  p <= j
        p = torch.searchsorted(prefix, v, right=True)
        hist += torch.bincount(p, minlength=m + 1)
        if m == T1:
            eq += torch.sum(v == b[-1])
    out = torch.zeros(T1 + 1, dtype=torch.int64, device=flat.device)
    out[:m] = torch.cumsum(hist[:m], dim=0)
    out[T1] = eq
    return out


def cumulative_counts_ref(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Oracle for ``cumulative_counts``: :func:`counts_ref` as float32, the
    reference's ``(T+2,)`` contract."""
    return counts_ref(x, boundaries).to(torch.float32)


def bucket_sizes_from_cumulative(cum: torch.Tensor) -> torch.Tensor:
    """Per-bucket sizes from the ``(T+2,)`` counts: bucket i holds
    ``[b_i, b_{i+1})`` and the last bucket also ``#(x == b_T)`` (right-
    closed).  Differences are taken in ``cum``'s own dtype: on integer
    counts they stay exact at any total."""
    lt, eq_last = cum[:-1], cum[-1]
    sizes = lt[1:] - lt[:-1]
    sizes[-1] += eq_last
    return sizes


def masked_cuts(ns, T: int) -> np.ndarray:
    """``floor(i·n/T)`` for i = 0..T per row, ``(rows, T+1)`` int64, in the
    reference's exact integer form ``i·q + (i·r)//T``."""
    n = np.asarray(ns, np.int64).reshape(-1, 1)
    i = np.arange(T + 1, dtype=np.int64)[None, :]
    return i * (n // T) + (i * (n % T)) // T


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Oracle for the row sort: ascending ``torch.sort`` of each row (NaN
    last, -0 == +0)."""
    return torch.sort(x, dim=-1).values


def summarize_rows_ref(x: torch.Tensor, ns, num_buckets: int) -> torch.Tensor:
    """Oracle for the Summarizer: boundaries ``(rows, T+1)`` of each sorted
    row at the masked cuts ``min(floor(i·n/T), n-1)``."""
    sv = sort_rows_ref(x)
    n = torch.as_tensor(np.asarray(ns, np.int64).reshape(-1, 1))
    cuts = torch.minimum(torch.as_tensor(masked_cuts(ns, num_buckets)), n - 1)
    return torch.gather(sv, 1, cuts.to(sv.device))


def sort_kv_ref(keys: torch.Tensor, vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the kv sort: row-wise stable argsort on the keys, applied
    to both."""
    order = torch.argsort(keys, dim=-1, stable=True)
    return torch.gather(keys, -1, order), torch.gather(vals, -1, order)


def encode_keys(x: torch.Tensor) -> torch.Tensor:
    """The sort kernels' order-preserving 32-bit key of each float32 or
    int32 value, as int64 in ``[0, 2^32)``: keys compare as the values do
    under ``torch.sort`` — every NaN one key after +inf, -0 and +0 one
    key; int32 with its sign bit flipped."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if x.dtype == torch.int32:
        return u ^ 0x80000000
    if x.dtype != torch.float32:
        raise TypeError(f"keys are float32 or int32, not {x.dtype}")
    k = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    k = torch.where(x == 0, torch.full_like(k, 0x80000000), k)
    return torch.where(torch.isnan(x), torch.full_like(k, 0xFFFFFFFF), k)


def argsort_pairs_ref(keys: torch.Tensor, L: int) -> torch.Tensor:
    """Oracle for ``argsort_pairs``: ``(rows, L)`` int64 whose bits are
    ``(key << 32) | index`` of the stable row-wise argsort of ``keys (rows,
    l_real)``, positions ``g >= l_real`` holding ``0xFFFFFFFF << 32 | g``."""
    rows, lreal = keys.shape
    order = torch.argsort(keys, dim=-1, stable=True)
    hi = torch.full((rows, L), 0xFFFFFFFF, dtype=torch.int64, device=keys.device)
    hi[:, :lreal] = torch.gather(encode_keys(keys), 1, order)
    lo = torch.arange(L, dtype=torch.int64, device=keys.device).repeat(rows, 1)
    lo[:, :lreal] = order
    # hi as a signed 32-bit word, so that hi · 2^32 + lo has the pair's bits
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def merge_ref(
    bounds: torch.Tensor, sizes: torch.Tensor, beta: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the batched merge: ``(Q, k, T+1)``/``(Q, k, T)`` →
    ``(Q, β+1)``/``(Q, β)``, the rank-select form of paper Algorithm 1
    exactly as ``repro.core.histogram.merge``, with a batch axis."""
    Q, k, _ = bounds.shape
    mass = torch.cat(
        [sizes, torch.zeros((Q, k, 1), dtype=sizes.dtype, device=sizes.device)],
        dim=-1,
    ).reshape(Q, -1)
    flat = bounds.reshape(Q, -1)
    order = torch.argsort(flat, dim=-1, stable=True)
    pos = torch.gather(flat, 1, order)
    cum = torch.cumsum(torch.gather(mass, 1, order), dim=-1)
    A = cum[:, :-1].contiguous()
    n = sizes.reshape(Q, -1).sum(dim=-1)
    # n / β as a tensor division: correctly rounded on every device (a CUDA
    # division by a Python scalar multiplies by its reciprocal instead)
    step = n / torch.full_like(n, beta)
    targets = torch.arange(1, beta, dtype=A.dtype, device=A.device)[None, :] * step[:, None]
    cut = torch.searchsorted(A, targets.contiguous(), right=True)
    interior = torch.gather(pos, 1, cut)
    boundaries = torch.cat([pos[:, :1], interior, pos[:, -1:]], dim=-1)
    prev = torch.gather(A, 1, torch.clamp(cut - 1, min=0))
    s_at_cut = torch.where(cut > 0, prev, torch.zeros_like(prev))
    full = torch.cat([torch.zeros_like(n)[:, None], s_at_cut, n[:, None]], dim=-1)
    return boundaries, torch.diff(full, dim=-1)
