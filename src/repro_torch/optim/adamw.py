"""AdamW with histogram-quantile clipping — functional, over trees of tensors.

PyTorch port of ``repro.optim.adamw``: the same functions over nested
dicts, lists and tuples of tensors (:mod:`repro_torch.tree`), run under
``torch.no_grad()``, with every state a tensor where the parameters lie.
Moments mirror parameter sharding (their logical specs are the parameter
specs), so optimizer state is ZeRO-sharded for free.  ``clip_mode``:

  * ``none``         — raw gradients
  * ``global_norm``  — classic clip-by-global-norm
  * ``quantile``     — **the paper integration**: clip each |g| at the
    approximate ``clip_q`` quantile of the *whole gradient tree's*
    magnitude distribution, computed by merging per-leaf equi-depth
    summaries (Theorem 1 bounds the rank error of the threshold by
    ``2/T`` of the element count — a principled, scale-free clip that
    costs one tiny merge instead of a global sort).  The threshold stays
    a tensor on the device: clipping never reads it back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.telemetry import grad_quantile
from repro_torch.device import as_tensor, home
from repro_torch.tree import leaves, tree_map

__all__ = [
    "OptimizerConfig",
    "adamw_update",
    "clip_grads",
    "init_opt_state",
    "lr_schedule",
    "opt_state_specs",
]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_mode: str = "global_norm"  # none | global_norm | quantile
    clip_value: float = 1.0  # max norm for global_norm
    clip_q: float = 0.999  # quantile for quantile mode
    clip_hist_T: int = 512
    moment_dtype: str = "float32"
    grad_accum: int = 1


def lr_schedule(cfg: OptimizerConfig, step, *, device=None) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``min_lr_ratio · peak_lr``; float32, where ``step`` lies."""
    step = as_tensor(step, device).to(torch.float32)
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    decayed = cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
    return torch.where(step < cfg.warmup_steps, warm, decayed)


def init_opt_state(params: Any, cfg: OptimizerConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and an
    int32 step counter where the first parameter lies."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=home(*leaves(params))),
    }


def opt_state_specs(param_specs: Any) -> dict:
    """Moment sharding == parameter sharding (ZeRO-sharded for free)."""
    return {
        "m": param_specs,
        "v": param_specs,
        "step": (),
    }


@torch.no_grad()
def clip_grads(
    grads: Any,
    cfg: OptimizerConfig,
    *,
    mesh=None,
    axis_names: tuple[str, ...] = (),
) -> tuple[Any, dict]:
    """``(clipped grads, metrics)`` for ``cfg.clip_mode``; every metric a
    0-d tensor on the device of the gradients."""
    if cfg.clip_mode == "none":
        return grads, {"grad_norm": _global_norm(grads)}
    if cfg.clip_mode == "global_norm":
        gnorm = _global_norm(grads)
        scale = torch.clamp(torch.full_like(gnorm, cfg.clip_value) / (gnorm + 1e-9), max=1.0)
        return tree_map(lambda g: g * scale, grads), {"grad_norm": gnorm}
    if cfg.clip_mode == "quantile":
        thr = grad_quantile(
            grads, cfg.clip_q, cfg.clip_hist_T, mesh=mesh, axis_names=axis_names
        )
        clipped = tree_map(lambda g: torch.clamp(g, -thr, thr), grads)
        return clipped, {
            "grad_norm": _global_norm(grads),
            "clip_threshold": thr,
        }
    raise ValueError(cfg.clip_mode)


def _global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree))
    )


@torch.no_grad()
def adamw_update(
    grads: Any, opt_state: dict, params: Any, cfg: OptimizerConfig
) -> tuple[Any, dict, dict]:
    """One AdamW step: ``(new params, new state, {"lr": lr})``; the inputs
    are left as they are."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step.to(torch.float32))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m_n = b1 * m32 + (1 - b1) * g
        v_n = b2 * v32 + (1 - b2) * g * g
        mhat = m_n / bc1
        vhat = v_n / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(
            torch.float32
        )
        return (
            (p.to(torch.float32) - lr * delta).to(p.dtype),
            m_n.to(m.dtype),
            v_n.to(v.dtype),
        )

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    # out is a tree of 3-tuples; unzip
    pick = lambda i: tree_map(lambda g, t: t[i], grads, out)
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"lr": lr}
