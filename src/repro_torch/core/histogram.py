"""Equi-depth histogram construction and merging with quality guarantees.

PyTorch port of ``repro.core.histogram`` — the core contribution of

    Yıldız, Büyüktanır, Emekci — "Equi-depth Histogram Construction for Big
    Data with Quality Guarantees" (cs.DB, 2016)

A ``T``-bucket histogram is ``boundaries (..., T+1)`` (increasing) and
``sizes (..., T)``; bucket ``i`` spans ``[b_i, b_{i+1})``, the last one
closed on the right.  The merge is the paper's Algorithm 1 in its parallel
rank-select form (one stable sort, one cumulative sum, one batched binary
search — see the reference module's docstring for the equivalence proof),
and the error bound of Theorems 1 and 2 is ``ε_max < 2N/T`` (``+2k`` when
``T ∤ |P_i|``).

Functions on tensors run where their input lies.  Every sort and merge
here goes through the port's kernels (:mod:`repro_torch.kernels`):
the hand-written CUDA kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors.  Array-likes that are not tensors (NumPy arrays,
lists) go to the card unless a ``device=`` keyword names another device
(:mod:`repro_torch.device`; no card and no ``device`` raises), with
64-bit types narrowed to 32 bits as the reference's ``jnp.asarray`` does.
Beside a tensor, they go where the tensor lies.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.device import as_tensor, home
from repro_torch.kernels import merge_batched, ref, sort_kv, sort_rows, summarize_rows

__all__ = [
    "Histogram",
    "as_tensor",
    "build_exact",
    "build_exact_batched",
    "build_exact_padded",
    "build_exact_padded_batched",
    "pad_pow2",
    "pad_sentinel",
    "next_pow2",
    "merge",
    "merge_list",
    "merge_histograms_sequential",
    "pre_histogram",
    "quantile",
    "cdf_left_collapse",
    "cdf_interp",
    "range_count",
    "boundary_error",
    "size_error",
    "theoretical_eps_max",
    "empirical_sizes",
    "empirical_size_error",
    "sample_histogram",
]

# narrower types the kernels sort as 32-bit values (exactly)
_WIDEN = {
    torch.float16: torch.float32,
    torch.bfloat16: torch.float32,
    torch.int8: torch.int32,
    torch.uint8: torch.int32,
    torch.int16: torch.int32,
}


class Histogram(NamedTuple):
    """An (approximate) equi-depth histogram.

    boundaries: ``(..., T+1)`` increasing bucket boundaries.
    sizes:      ``(..., T)``   per-bucket value counts (float for
                               mergeability; exact integers below 2^24).
    """

    boundaries: torch.Tensor
    sizes: torch.Tensor

    @property
    def num_buckets(self) -> int:
        return self.sizes.shape[-1]

    @property
    def n(self) -> torch.Tensor:
        """Total number of summarized values."""
        return torch.sum(as_tensor(self.sizes, home(self.boundaries)), dim=-1)

    def cumulative(self) -> torch.Tensor:
        """``S(i, H)`` for i = 1..T, shape ``(..., T)``."""
        return torch.cumsum(as_tensor(self.sizes, home(self.boundaries)), dim=-1)


# ---------------------------------------------------------------------------
# Exact construction (the paper's Summarizer)
# ---------------------------------------------------------------------------


def next_pow2(k: int) -> int:
    """Smallest power of two ≥ ``k`` (``k ≥ 1``) — the padding rule for
    every shape-stable batch/length axis."""
    return 1 << max(0, k - 1).bit_length()


def pad_sentinel(dtype):
    """The pad value of ``dtype``, which sorts past every real value:
    ``+inf`` for floating types, the dtype's maximum for integers."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return float("inf")
    return int(np.iinfo(dtype).max)


def pad_pow2(values, min_len: int = 1) -> tuple[np.ndarray, int]:
    """Pad a 1-D array to the next power-of-two length with a +inf sentinel
    (dtype max for integers).  Returns ``(padded, n)``, ``n`` the true
    length; the pad sorts to the tail and no masked cut reaches it.

    Counts what it writes on the host where it makes it: the sentinels in
    ``ingest.padded_values`` and the bytes of the fill and the padded copy
    in ``ingest.host_copy_bytes`` (:mod:`~repro_torch.core.spans`)."""
    v = np.asarray(values).reshape(-1)
    n = int(v.shape[0])
    if n < 1:
        raise ValueError("cannot summarize an empty partition")
    n_pad = next_pow2(max(n, min_len))
    if n_pad == n:
        return v, n
    tail = np.full(n_pad - n, pad_sentinel(v.dtype), v.dtype)
    padded = np.concatenate([v, tail])
    spans.count("ingest.padded_values", tail.size)
    spans.count("ingest.host_copy_bytes", tail.nbytes + padded.nbytes)
    return padded, n


def _sizes(ns, num_buckets: int, count_dtype, device) -> torch.Tensor:
    # a host-to-device copy that does not wait for the stream: CUDA stages
    # pageable host memory before the copy call returns
    sizes = torch.as_tensor(np.diff(ref.masked_cuts(ns, num_buckets), axis=-1)).to(count_dtype)
    return sizes.to(device, non_blocking=True)


def build_exact_padded_batched(
    values, ns, num_buckets: int, count_dtype=torch.float32, *, device=None
) -> Histogram:
    """Summarizer of a ``(k, n_pad)`` stack of partitions with true lengths
    ``ns (k,)`` (host integers): one sort of every row and a gather of the
    ``T+1`` boundaries at the masked cuts ``floor(i·n/T)``.  Bit-identical
    to :func:`build_exact` of each row's first ``n`` values when the rest
    is padding that sorts past them (:func:`pad_pow2`)."""
    x = as_tensor(values, device)
    ns = np.asarray(ns, np.int64).reshape(-1)
    wide = _WIDEN.get(x.dtype) if x.device.type == "cuda" else None
    if wide is None:
        b = summarize_rows(x.contiguous(), ns, num_buckets)
    else:  # the sort kernel takes 32-bit keys; the round trip is exact
        b = summarize_rows(x.to(wide).contiguous(), ns, num_buckets).to(x.dtype)
    return Histogram(boundaries=b, sizes=_sizes(ns, num_buckets, count_dtype, x.device))


def build_exact_padded(
    values, n, num_buckets: int, count_dtype=torch.float32, *, device=None
) -> Histogram:
    """Mask-aware :func:`build_exact` over one sentinel-padded partition."""
    h = build_exact_padded_batched(
        as_tensor(values, device).reshape(1, -1), [int(n)], num_buckets, count_dtype
    )
    return Histogram(h.boundaries[0], h.sizes[0])


def build_exact(
    values, num_buckets: int, count_dtype=torch.float32, *, device=None
) -> Histogram:
    """Exact ``T``-bucket equi-depth histogram of a 1-D value array: sort
    the partition and cut it into ``T`` near-equal runs.  ``O(n log n)``."""
    x = as_tensor(values, device).reshape(-1)
    if x.shape[0] < 1:
        raise ValueError("cannot summarize an empty partition")
    return build_exact_padded(x, x.shape[0], num_buckets, count_dtype)


def build_exact_batched(
    values, num_buckets: int, count_dtype=torch.float32, *, device=None
) -> Histogram:
    """:func:`build_exact` of each row of ``values (k, n)``."""
    x = as_tensor(values, device)
    return build_exact_padded_batched(x, [x.shape[1]] * x.shape[0], num_buckets, count_dtype)


# ---------------------------------------------------------------------------
# The merge — parallel rank-select form (production path)
# ---------------------------------------------------------------------------


def pre_histogram(histograms: Histogram, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's pre-histogram ``H⁰`` of stacked summaries
    ``boundaries (k, T+1)``/``sizes (k, T)``: ``(pos, A)`` with ``pos`` the
    stably sorted flat boundaries ``(k(T+1),)`` and ``A`` the left-collapse
    cumulative sizes ``(k(T+1) - 1,)``."""
    b, s = _pair(histograms, device)
    k = b.shape[0]
    mass = torch.cat([s, torch.zeros((k, 1), dtype=s.dtype, device=s.device)], dim=-1)
    pos, m = sort_kv(b.reshape(1, -1).contiguous(), mass.reshape(1, -1))
    return pos[0], torch.cumsum(m[0], dim=0)[:-1]


def merge(histograms: Histogram, beta: int, *, device=None) -> Histogram:
    """Merge ``k`` stacked ``T``-bucket summaries into a β-bucket histogram
    (rank-select form of paper Algorithm 1; the batched merge kernel on a
    CUDA tensor)."""
    b, s = _pair(histograms, device)
    wide = _WIDEN.get(b.dtype) if b.device.type == "cuda" else None
    bk = b if wide is None else b.to(wide)  # the merge only selects values
    bo, so = merge_batched(bk[None].contiguous(), s[None].contiguous(), beta)
    return Histogram(boundaries=bo[0].to(b.dtype), sizes=so[0])


def merge_list(histograms: Sequence[Histogram], beta: int, *, device=None) -> Histogram:
    """Merge a list of (possibly differently-sized) summaries; narrower
    ones are padded with zero-size buckets at their last boundary, which
    leaves equation (★) unchanged."""
    T_max = max(h.sizes.shape[-1] for h in histograms)
    device = home(*(x for h in histograms for x in h), device=device)
    bs, ss = [], []
    for h in histograms:
        b, s = _pair(h, device)
        pad = T_max - s.shape[-1]
        bs.append(torch.cat([b, b[-1:].repeat(pad)]))
        ss.append(torch.cat([s, torch.zeros((pad,), dtype=s.dtype, device=s.device)]))
    return merge(Histogram(torch.stack(bs), torch.stack(ss)), beta)


# ---------------------------------------------------------------------------
# The merge — faithful sequential Algorithm 1 (reference / paper baseline)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def merge_histograms_sequential(
    histograms: Sequence[Histogram] | Histogram, beta: int, *, device=None
) -> Histogram:
    """Host-side port of paper Algorithm 1 (two-pointer sweep): the oracle
    of the vectorized :func:`merge`.  ``O(kT log k + kT)``.  The result
    goes where the input lies (or to ``device``)."""
    if isinstance(histograms, Histogram):
        device = home(*histograms, device=device)
        b = _host(histograms.boundaries)
        s = _host(histograms.sizes)
    else:
        device = home(*(x for h in histograms for x in h), device=device)
        b = np.stack([_host(h.boundaries) for h in histograms])
        s = np.stack([_host(h.sizes) for h in histograms])
    k = b.shape[0]
    mass = np.concatenate([s, np.zeros((k, 1), s.dtype)], axis=-1).reshape(-1)
    flat = b.reshape(-1)
    order = np.argsort(flat, kind="stable")
    pos = flat[order]
    cum = np.cumsum(mass[order])
    A = cum[:-1]  # A[m-1] == A(m, H⁰)
    n = float(s.sum())

    out_b = [pos[0]]
    out_s = []
    prev_cum = 0.0
    nxt = 0  # paper's `next` pointer (monotone)
    for j in range(1, beta):
        target = j * n / beta
        while nxt < A.shape[0] and A[nxt] <= target:
            nxt += 1
        out_b.append(pos[nxt])
        cum_here = A[nxt - 1] if nxt > 0 else 0.0
        out_s.append(cum_here - prev_cum)
        prev_cum = cum_here
    out_b.append(pos[-1])
    out_s.append(n - prev_cum)
    return Histogram(
        boundaries=as_tensor(np.array(out_b), device),
        sizes=as_tensor(np.array(out_s, dtype=np.float32), device),
    )


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def _pair(hist: Histogram, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``hist``'s boundaries and sizes as tensors on one device: ``device``
    if given, else where a tensor among them lies, else the card."""
    device = home(*hist, device=device)
    b = as_tensor(hist.boundaries, device)
    return b, as_tensor(hist.sizes, b.device)


def _zero_cum(hist: Histogram, device) -> tuple[torch.Tensor, torch.Tensor]:
    b, s = _pair(hist, device)
    cum = torch.cat([torch.zeros_like(s[..., :1]), torch.cumsum(s, dim=-1)], dim=-1)
    return b, cum


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` (constant extrapolation) on a
    ``searchsorted``: same bracketing, same flat-segment rule."""
    dt = torch.promote_types(torch.promote_types(x.dtype, xp.dtype), torch.float32)
    x, xp = x.to(dt), xp.to(dt)
    fp = fp.to(torch.promote_types(fp.dtype, torch.float32))
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    # take, not fp[i]: indexing by a 0-d tensor reads it back to the host
    f_hi, f_lo = torch.take(fp, i), torch.take(fp, i - 1)
    x_lo = torch.take(xp, i - 1)
    df = f_hi - f_lo
    dx = torch.take(xp, i) - x_lo
    delta = x - x_lo
    eps = float(np.spacing(np.finfo(np.float32 if dt == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def cdf_left_collapse(hist: Histogram, x, *, device=None) -> torch.Tensor:
    """CDF estimate under the paper's left-collapse assumption: the mass of
    the buckets whose left boundary is ≤ x (within ``±2N/T`` of truth)."""
    b, cum = _zero_cum(hist, home(*hist, x, device=device))
    x = as_tensor(x, b.device).to(b.dtype)
    idx = torch.searchsorted(b[..., :-1].contiguous(), x.contiguous(), right=True)
    return cum[idx]


def cdf_interp(hist: Histogram, x, *, device=None) -> torch.Tensor:
    """Piecewise-linear CDF estimate (mass uniform inside each bucket)."""
    b, cum = _zero_cum(hist, home(*hist, x, device=device))
    return _interp(as_tensor(x, b.device), b, cum)


def quantile(hist: Histogram, q, *, device=None) -> torch.Tensor:
    """Approximate q-quantile (vector ``q`` ok) by inverse interpolated CDF;
    rank error within the paper's ``ε_max``."""
    b, cum = _zero_cum(hist, home(*hist, q, device=device))
    n = cum[..., -1]
    return _interp(as_tensor(q, b.device).to(torch.float32) * n, cum, b)


def range_count(hist: Histogram, lo, hi, *, device=None) -> torch.Tensor:
    """Approximate number of values in ``[lo, hi)`` (Theorem 2 quantity)."""
    device = home(*hist, lo, hi, device=device)
    return cdf_interp(hist, hi, device=device) - cdf_interp(hist, lo, device=device)


# ---------------------------------------------------------------------------
# Error metrics (paper Eq. 9 and Eq. 10) and the theoretical bound
# ---------------------------------------------------------------------------


def boundary_error(approx: Histogram, exact: Histogram, *, device=None) -> torch.Tensor:
    """μ_b — normalized RMS boundary deviation (paper Eq. 9)."""
    B = approx.num_buckets
    device = home(approx.boundaries, exact.boundaries, device=device)
    ba, be = as_tensor(approx.boundaries, device), as_tensor(exact.boundaries, device)
    vmax, vmin = be[-1], be[0]
    rms = torch.sqrt(torch.mean((ba - be).to(torch.float32) ** 2))
    return B / (vmax - vmin) * rms


def size_error(approx: Histogram, exact: Histogram, *, device=None) -> torch.Tensor:
    """μ_s — normalized RMS bucket-size deviation (paper Eq. 10)."""
    B = approx.num_buckets
    device = home(approx.sizes, exact.sizes, device=device)
    sa, se = as_tensor(approx.sizes, device), as_tensor(exact.sizes, device)
    n = torch.sum(se)
    rms = torch.sqrt(torch.mean((sa - se) ** 2))
    return B / n * rms


def theoretical_eps_max(n: float, T: int, k: int = 1, exact_inputs: bool = True) -> float:
    """Paper bound ``ε_max < 2N/T`` (+``2k`` integer slack)."""
    slack = 0.0 if exact_inputs else 2.0 * k
    return 2.0 * n / T + slack


def empirical_sizes(values, boundaries, *, device=None) -> torch.Tensor:
    """TRUE per-bucket counts of ``values`` under ``boundaries`` (last
    bucket right-closed) — what the paper's μ_s measures."""
    device = home(values, boundaries, device=device)
    v = sort_rows(as_tensor(values, device).reshape(1, -1).contiguous())[0]
    b = as_tensor(boundaries, v.device).to(v.dtype).contiguous()
    lo = torch.searchsorted(v, b[:-1])
    hi = torch.searchsorted(v, b[1:])
    sizes = (hi - lo).to(torch.float32)
    sizes[-1] += torch.sum((v == b[-1]).to(torch.float32))
    return sizes


def empirical_size_error(approx: Histogram, values, *, device=None) -> torch.Tensor:
    """μ_s (paper Eq. 10) with true bucket occupancy under approx boundaries."""
    v = as_tensor(values, home(values, approx.boundaries, device=device))
    B = approx.num_buckets
    n = v.numel()
    true_sizes = empirical_sizes(v, approx.boundaries)
    rms = torch.sqrt(torch.mean((true_sizes - n / B) ** 2))
    return B / n * rms


# ---------------------------------------------------------------------------
# The paper's comparison baseline: corrected tuple-level random sampling
# ---------------------------------------------------------------------------


def sample_histogram(
    values, num_buckets: int, sample_size: int, generator: torch.Generator, *, device=None
) -> Histogram:
    """`tuple` baseline of paper §7 — random sample + exact histogram of it,
    with the global min and max force-included; sizes scaled back to
    ``N``.  The sample is drawn with ``generator`` on the values' device
    (the generator must live there)."""
    v = as_tensor(values, device)
    n = v.shape[0]
    idx = torch.randint(0, n, (sample_size,), generator=generator, device=v.device)
    sample = torch.cat([v.min()[None], v[idx], v.max()[None]])
    h = build_exact(sample, num_buckets)
    return Histogram(boundaries=h.boundaries, sizes=h.sizes * (n / sample.shape[0]))
