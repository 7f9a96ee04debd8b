"""Grouped-query attention with the assigned archs' variants.

Port of ``repro.models.attention``: GQA/MQA/MHA (kv groups), RoPE,
qk-norm (qwen3), tanh logit softcapping and sliding-window local layers
(gemma-2), non-causal attention (the whisper encoder), cross-attention
to encoder states (the whisper decoder), and single-token decode against
a KV cache.  Weights are head-major, ``(d, H, hd)``, as in the reference.

The KV cache is written in place: at ``[0, S)`` by :func:`prefill_attention`
and at ``position`` by :func:`decode_attention_step` (the reference's
``dynamic_update_slice`` under ``donate_argnums``, start clamped to
``Smax - 1`` as XLA clamps it), whose position is a tensor on the cache's
device, so that a decode step holds no host value of it.  Both return the
cache, as the reference does.  Cross-attention's keys and values come from
the encoder states, projected once a request (:func:`encode_cross_kv`) or
at each call.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (
    Init,
    apply_rope,
    cast,
    chunked_attention,
    decode_attention,
    rms_norm,
)


def init_attention(cfg, rng: Init) -> dict:
    d, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {
        "wq": rng.dense((d, Hq, hd)),
        "wk": rng.dense((d, Hkv, hd)),
        "wv": rng.dense((d, Hkv, hd)),
        "wo": rng.dense((Hq, hd, d), fan_in=Hq * hd),
    }
    if cfg.qk_norm:
        params["q_norm"] = rng.zeros((hd,))
        params["k_norm"] = rng.zeros((hd,))
    return params


def attention_specs(cfg) -> dict:
    """The logical sharding of :func:`init_attention`'s tree."""
    specs = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = (None,)
        specs["k_norm"] = (None,)
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``."""
    d, h, k = w.shape
    return (x @ cast(w, x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``."""
    h, k, d = w.shape
    return o.flatten(-2) @ cast(w, o.dtype).reshape(h * k, d)


def _project_qkv(cfg, p, x, positions, rope: bool):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg, kind: str) -> int | None:
    return cfg.sliding_window if kind == "local" else None


def _attend(cfg, p, x, positions, kind: str, causal: bool, rope: bool):
    """Attention over the whole sequence → ``(y, k, v)``."""
    B, S, _ = x.shape
    Hkv, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(cfg, p, x, positions, rope)
    out = chunked_attention(
        q.reshape(B, S, Hkv, G, cfg.head_dim), k, v, causal=causal,
        window=_window(cfg, kind), logit_cap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
    )
    return _out(out.reshape(B, S, cfg.num_heads, cfg.head_dim), p["wo"]), k, v


def apply_attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, *, kind: str = "global",
                    causal: bool = True, rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / eval; ``causal=False`` for the
    encoder).  x: ``(B, S, d)``."""
    return _attend(cfg, p, x, positions, kind, causal, rope)[0]


def apply_cross_attention(cfg, p, x: torch.Tensor, enc_kv: tuple[torch.Tensor, torch.Tensor] | None,
                          enc_states: torch.Tensor | None = None) -> torch.Tensor:
    """Whisper-style cross-attention of the decoder stream x ``(B, S, d)``
    to the encoder: keys and values ``enc_kv`` (from
    :func:`encode_cross_kv`) or, when it is ``None``, projected from
    ``enc_states``.  No RoPE, no qk-norm, no logit cap; not causal."""
    B, S, _ = x.shape
    Hkv, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = _proj(x, p["wq"])
    k, v = encode_cross_kv(cfg, p, enc_states) if enc_kv is None else enc_kv
    out = chunked_attention(q.reshape(B, S, Hkv, G, cfg.head_dim), k, v, causal=False, q_chunk=cfg.attn_q_chunk)
    return _out(out.reshape(B, S, cfg.num_heads, cfg.head_dim), p["wo"])


def encode_cross_kv(cfg, p, enc_states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's keys and values ``(B, S_enc, Hkv, hd)`` from the
    encoder states, in their dtype: computed once a request (prefill)."""
    return _proj(enc_states, p["wk"]), _proj(enc_states, p["wv"])


def init_kv_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_specs() -> dict:
    """The logical sharding of :func:`init_kv_cache`'s tree."""
    return {"k": ("batch_kv", "kv_seq", "kv_heads_cache", None),
            "v": ("batch_kv", "kv_seq", "kv_heads_cache", None)}


def prefill_attention(cfg, p, x, positions, cache, *, kind: str = "global"):
    """Full-sequence attention that also fills the KV cache ``[0, S)``."""
    y, k, v = _attend(cfg, p, x, positions, kind, True, cfg.use_rope)
    S = x.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return y, cache


def decode_attention_step(cfg, p, x, position: torch.Tensor, cache: dict, *, kind: str = "global"):
    """One-token decode: project, write the cache at ``position`` (an int32
    tensor of one element on x's device), attend.  x: ``(B, 1, d)``."""
    B = x.shape[0]
    Hkv, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(cfg, p, x, position, cfg.use_rope)
    slot = position.clamp(0, cache["k"].shape[1] - 1).long()  # XLA clamps the start
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    out = decode_attention(
        q.reshape(B, 1, Hkv, G, cfg.head_dim), cache["k"], cache["v"], position,
        window=_window(cfg, kind), logit_cap=cfg.attn_softcap,
    ).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    return _out(out, p["wo"]), cache
