"""RWKV-6 "Finch" block: a linear recurrence with data-dependent decay.

Port of ``repro.models.rwkv``: per-channel decay ``w_t = exp(-exp(ŵ_t))``
from a LoRA on the token-shifted input, the bonus ``u`` on the current
token, a float32 ``(K × V)`` state per head, token-shift mixing with
static learned coefficients on every projection (the reference's
simplification of RWKV-6's ddlerp), and the squared-ReLU channel mix.

The recurrence runs in whole chunks of ``cfg.rwkv_chunk`` and then a tail
that is not a whole chunk, carrying the state; inside a chunk it runs
step by step in float32: ``kv = k ⊗ v``, ``y = r · (S + u · kv)``,
``S ← w · S + kv``.  Under a ``remat_policy`` other than ``"none"`` each
chunk runs under ``torch.utils.checkpoint`` while autograd records, as the
reference wraps it in ``jax.checkpoint``.  Decode is the same loop over
one token: an O(1) state update.

The loop is plain torch, as the reference's is plain ``jnp``: S steps of
a few small launches each.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import Init, cast, layer_norm

__all__ = [
    "apply_rwkv_channel_mix", "apply_rwkv_time_mix", "init_rwkv_cache", "init_rwkv_channel_mix",
    "init_rwkv_time_mix", "rwkv_cache_specs", "rwkv_channel_mix_specs", "rwkv_time_mix_specs",
]


def init_rwkv_time_mix(cfg, rng: Init) -> dict:
    d = cfg.d_model
    H, hd = cfg.rwkv_heads, cfg.d_model // cfg.rwkv_heads
    lora = cfg.rwkv_decay_lora
    return {
        "mix_r": rng.normal((d,), 0.2),
        "mix_k": rng.normal((d,), 0.2),
        "mix_v": rng.normal((d,), 0.2),
        "mix_g": rng.normal((d,), 0.2),
        "mix_w": rng.normal((d,), 0.2),
        "w0": rng.normal((d,), 0.5),
        "wA": rng.dense((d, lora)),
        "wB": rng.dense((lora, d), fan_in=lora),
        "u": rng.normal((H, hd), 0.5),
        "wr": rng.dense((d, d)),
        "wk": rng.dense((d, d)),
        "wv": rng.dense((d, d)),
        "wg": rng.dense((d, d)),
        "wo": rng.dense((d, d)),
        "ln_g": rng.ones((d,)),
        "ln_b": rng.zeros((d,)),
    }


def rwkv_time_mix_specs() -> dict:
    """The logical sharding of :func:`init_rwkv_time_mix`'s tree."""
    return {
        "mix_r": (None,), "mix_k": (None,), "mix_v": (None,), "mix_g": (None,), "mix_w": (None,),
        "w0": (None,), "wA": ("embed", None), "wB": (None, "embed"),
        "u": ("rwkv_heads", None),
        "wr": ("embed", "rwkv_proj"), "wk": ("embed", "rwkv_proj"), "wv": ("embed", "rwkv_proj"),
        "wg": ("embed", "rwkv_proj"), "wo": ("rwkv_proj", "embed"),
        "ln_g": (None,), "ln_b": (None,),
    }


def init_rwkv_channel_mix(cfg, rng: Init) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": rng.normal((d,), 0.2),
        "mix_r": rng.normal((d,), 0.2),
        "wk": rng.dense((d, f)),
        "wr": rng.dense((d, d)),
        "wv": rng.dense((f, d), fan_in=f),
    }


def rwkv_channel_mix_specs() -> dict:
    """The logical sharding of :func:`init_rwkv_channel_mix`'s tree."""
    return {"mix_k": (None,), "mix_r": (None,), "wk": ("embed", "mlp"), "wr": ("embed", None), "wv": ("mlp", "embed")}


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried last token, at t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, x_prev, mu):
    """``x + (x_prev − x) · sigmoid(μ)``, the sigmoid in μ's dtype cast to x's."""
    return x + (x_prev - x) * torch.sigmoid(mu).to(x.dtype)


def _time_mix_projections(cfg, p, x, x_prev):
    dt = x.dtype
    H, hd = cfg.rwkv_heads, cfg.d_model // cfg.rwkv_heads
    r = _mix(x, x_prev, p["mix_r"]) @ cast(p["wr"], dt)
    k = _mix(x, x_prev, p["mix_k"]) @ cast(p["wk"], dt)
    v = _mix(x, x_prev, p["mix_v"]) @ cast(p["wv"], dt)
    g = _mix(x, x_prev, p["mix_g"]) @ cast(p["wg"], dt)
    xw = _mix(x, x_prev, p["mix_w"])
    w_hat = p["w0"].float() + (torch.tanh(xw.float()) @ p["wA"].float()) @ p["wB"].float()
    w = torch.exp(-torch.exp(w_hat))  # (B, S, d): the data-dependent decay, float32
    shp = x.shape[:2] + (H, hd)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), g, w.reshape(shp)


def _chunk(u, S0, r, k, v, w):
    """One chunk, step by step in float32: ``(state (B, H, K, V), r, k, v,
    w (B, c, H, hd))`` → ``(the chunk's last state, y (B, c, H, V))``."""
    r, k, v, w = r.float(), k.float(), v.float(), w.float()
    S_, ys = S0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S_ + u[None, :, :, None] * kv))
        S_ = w[:, t, :, :, None] * S_ + kv
    return S_, torch.stack(ys, dim=1)


def apply_rwkv_time_mix(cfg, p, x: torch.Tensor, state: torch.Tensor | None = None,
                        x_carry: torch.Tensor | None = None):
    """x: ``(B, S, d)`` → ``(y, (final state (B, H, hd, hd) float32, last
    x (B, 1, d)))``; ``state`` and ``x_carry`` carry a previous call's."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, d // cfg.rwkv_heads
    dt = x.dtype
    r, k, v, g, w = _time_mix_projections(cfg, p, x, _shift(x, x_carry))
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    u = p["u"].float()
    c = min(cfg.rwkv_chunk, S)
    n_full = S // c

    def chunk(S0, lo, hi):
        args = (u, S0, r[:, lo:hi], k[:, lo:hi], v[:, lo:hi], w[:, lo:hi])
        if cfg.remat_policy != "none" and torch.is_grad_enabled():
            return checkpoint(_chunk, *args, use_reentrant=False)
        return _chunk(*args)

    ys, S_final = [], state
    for i in range(n_full):
        S_final, y = chunk(S_final, i * c, (i + 1) * c)
        ys.append(y)
    if S > n_full * c:  # the tail (e.g. a prefill of S + 1 tokens)
        S_final, y = chunk(S_final, n_full * c, S)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, d).to(dt)
    y = layer_norm(y, p["ln_g"], p["ln_b"])  # over all of d (the H groups folded)
    y = y * F.silu(g)
    return y @ cast(p["wo"], dt), (S_final, x[:, -1:])


def apply_rwkv_channel_mix(cfg, p, x: torch.Tensor, x_carry: torch.Tensor | None = None):
    """x: ``(B, S, d)`` → ``(y, last x (B, 1, d))``."""
    dt = x.dtype
    x_prev = _shift(x, x_carry)
    k = _mix(x, x_prev, p["mix_k"]) @ cast(p["wk"], dt)
    r = _mix(x, x_prev, p["mix_r"]) @ cast(p["wr"], dt)
    h = torch.square(torch.relu(k))
    return torch.sigmoid(r) * (h @ cast(p["wv"], dt)), x[:, -1:]


def init_rwkv_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    """``S`` ``(batch, H, hd, hd)`` float32 whatever ``dtype``; the carried
    last tokens ``x_tm`` and ``x_cm`` ``(batch, 1, d)`` in ``dtype``."""
    d = cfg.d_model
    H, hd = cfg.rwkv_heads, d // cfg.rwkv_heads
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "x_tm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
    }


def rwkv_cache_specs() -> dict:
    """The logical sharding of :func:`init_rwkv_cache`'s tree."""
    return {"S": ("batch_kv", "rwkv_heads", None, None), "x_tm": ("batch_kv", None, None),
            "x_cm": ("batch_kv", None, None)}
