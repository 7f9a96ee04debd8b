"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).

Port of ``repro.models.mlp``.  Weights are cast to the activations' dtype
at each use, as the reference does (no copy when they already have it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Init, cast


def init_mlp(cfg, rng: Init, *, gated: bool = True) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if gated:
        return {
            "w_gate": rng.dense((d, f)),
            "w_up": rng.dense((d, f)),
            "w_down": rng.dense((f, d), fan_in=f),
        }
    return {
        "w_up": rng.dense((d, f)),
        "b_up": rng.zeros((f,)),
        "w_down": rng.dense((f, d), fan_in=f),
        "b_down": rng.zeros((d,)),
    }


def mlp_specs(*, gated: bool = True) -> dict:
    """The logical sharding of :func:`init_mlp`'s tree."""
    if gated:
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    return {"w_up": ("embed", "mlp"), "b_up": ("mlp",), "w_down": ("mlp", "embed"), "b_down": (None,)}


def apply_mlp(cfg, p, x: torch.Tensor, *, gated: bool = True) -> torch.Tensor:
    dt = x.dtype
    if gated:
        g = x @ cast(p["w_gate"], dt)
        u = x @ cast(p["w_up"], dt)
        return (F.silu(g) * u) @ cast(p["w_down"], dt)
    h = x @ cast(p["w_up"], dt) + cast(p["b_up"], dt)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ cast(p["w_down"], dt) + cast(p["b_down"], dt)
