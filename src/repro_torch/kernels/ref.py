"""Plain PyTorch versions of every kernel on the port's path.

Each function is the semantic ground truth its CUDA kernel is held to (on
the card, by ``chip_smoke.py``), and what the kernel wrappers run for a
tensor that lies on the CPU.  Mirrors ``repro.kernels.ref``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "masked_cuts",
    "sort_rows_ref",
    "summarize_rows_ref",
    "sort_kv_ref",
    "merge_ref",
]


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
