"""Public entry points over the kernels: the port of ``repro.kernels.ops``.

- :func:`bucket_sizes` — true per-bucket counts of a value stream under
  given boundaries (the validation op), through the bucket-count kernel;
- :func:`summarize_tiles` — the tile Summarizer: sort tiles of the stream,
  take each tile's exact histogram, merge them (``summarize_pallas``);
- :func:`merge_histograms` — the Merger over stacked summaries
  (``merge_histograms_pallas``).

The TPU-only switches of the reference (``interpret``, ``block_rows``,
``fused_merge``) are gone: there is one route on each device, and both of
the reference's merge routes are :func:`~repro_torch.kernels.merge_batched`
here (bit-identical to each other in the reference below 2^24 mass).

Input that is not a tensor goes to ``device`` (``None`` → the card, and no
card raises: :mod:`repro_torch.device`); a tensor stays where it lies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import as_tensor, home
from repro_torch.kernels import ref
from repro_torch.kernels.bucket_count import counts
from repro_torch.kernels.merge_cut import merge_batched
from repro_torch.kernels.tile_sort import pad_to_tiles, summarize_rows

__all__ = ["bucket_sizes", "merge_histograms", "summarize_tiles"]


def bucket_sizes(x, boundaries, *, device=None) -> torch.Tensor:
    """True per-bucket counts ``(T,)`` float32 of ``x`` (any shape, cast to
    float32) under ``boundaries (T+1,)``; the last bucket is right-closed.

    The differences are taken on the kernel's integer counts before the
    cast, so every size is exact wherever it is below 2^24, whatever the
    stream's total (the reference differences float32 cumulative counts,
    which round once the total passes 2^24)."""
    x = as_tensor(x, home(x, boundaries, device=device))
    cum = counts(x, as_tensor(boundaries, x.device))
    return ref.bucket_sizes_from_cumulative(cum).to(torch.float32)


def summarize_tiles(
    x, *, tile_len: int = 4096, T_tile: int = 256, T_out: int = 1024, device=None
):
    """Tile Summarizer: ``summarize_pallas`` on the port's kernels.

    The stream (any shape, cast to float32) is padded with ``+inf`` to
    whole tiles of ``tile_len``; one row-sort launch gives every tile's
    exact ``T_tile``-bucket histogram at the integer cuts of its true
    length (the ragged last tile masks its padding), and one merge launch
    of all ``tiles`` summaries gives ``T_out`` buckets.  Approximate by
    design: each bucket is within ``2N/T_tile + 2·tiles`` of exact, so it
    does not stand in for the exact Summarizer (``build_exact``)."""
    from repro_torch.core.histogram import Histogram  # core imports kernels

    flat = as_tensor(x, device).reshape(-1).to(torch.float32)
    n = flat.shape[0]
    if n < 1:
        raise ValueError("cannot summarize an empty array")
    xt = pad_to_tiles(flat, tile_len).reshape(-1, tile_len).contiguous()
    tiles = xt.shape[0]
    n_i = np.minimum(tile_len, n - np.arange(tiles, dtype=np.int64) * tile_len)
    bounds = summarize_rows(xt, n_i, T_tile)
    sizes = torch.from_numpy(
        np.diff(ref.masked_cuts(n_i, T_tile), axis=-1).astype(np.float32)
    ).to(xt.device)
    bo, so = merge_batched(bounds[None], sizes[None], T_out)
    return Histogram(boundaries=bo[0], sizes=so[0])


def merge_histograms(stacked, beta: int, *, device=None):
    """Merger over stacked summaries ``(k, T+1)``/``(k, T)`` → β buckets,
    one merge launch (``merge_histograms_pallas``)."""
    from repro_torch.core.histogram import Histogram  # core imports kernels

    b = as_tensor(stacked.boundaries, home(*stacked, device=device))
    s = as_tensor(stacked.sizes, b.device)
    bo, so = merge_batched(b[None].contiguous(), s[None].contiguous(), beta)
    return Histogram(boundaries=bo[0], sizes=so[0])
