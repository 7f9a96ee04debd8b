"""Histogram-threshold gradient sparsification with error feedback.

PyTorch port of ``repro.optim.compression``, over trees of tensors
(:mod:`repro_torch.tree`).  Top-ρ gradient compression needs the (1-ρ)
quantile of |g| over billions of elements.  A global sort is a
non-starter; sampling gives no guarantee.  The paper's merge gives the
threshold with *bounded rank error* (Theorem 1: ``2/T`` of the element
count) from per-leaf (and on a mesh, per-rank) summaries, at ``O(k·T)``
communication.  The threshold stays a tensor on the device: the split
never reads it back to the host.

On a real deployment this sits *before* the gradient reduce-scatter (each
replica sparsifies its local gradient, exchanging only survivors); here it
applies to the reduced gradient, which preserves the convergence-relevant
semantics (error feedback keeps the residual) and the structural cost
model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.telemetry import grad_quantile
from repro_torch.tree import leaves, tree_map

__all__ = ["CompressionConfig", "compress_grads", "init_residual"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    rho: float = 0.01  # fraction of entries kept
    hist_T: int = 1024


def init_residual(params: Any) -> Any:
    """Zero float32 residuals beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


@torch.no_grad()
def compress_grads(
    grads: Any,
    residual: Any,
    ccfg: CompressionConfig,
    *,
    mesh=None,
    axis_names: tuple[str, ...] = (),
) -> tuple[Any, Any, dict]:
    """Returns (sparse_grads, new_residual, metrics)."""
    acc = tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    thr = grad_quantile(
        acc, 1.0 - ccfg.rho, ccfg.hist_T, mesh=mesh, axis_names=axis_names
    )

    def split(a):
        keep = torch.abs(a) >= thr
        return torch.where(keep, a, 0.0), torch.where(keep, 0.0, a)

    out = tree_map(split, acc)
    sparse = tree_map(lambda a, t: t[0], acc, out)
    new_resid = tree_map(lambda a, t: t[1], acc, out)
    total = sum(g.numel() for g in leaves(grads))
    kept = sum(
        torch.sum((torch.abs(a) >= thr).to(torch.float32)) for a in leaves(acc)
    )
    return sparse, new_resid, {
        "compress_threshold": thr,
        "compress_kept_fraction": kept / total,
    }
