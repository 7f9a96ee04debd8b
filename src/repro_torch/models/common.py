"""Shared model primitives: the initializer, norms, RoPE, the attention
cores and the chunked cross-entropy.

Port of ``repro.models.common`` on PyTorch.  Parameters are plain nested
dicts (and lists) of tensors, as in the reference; their logical sharding
specs come from separate functions beside each ``init_*``
(``models.model.param_specs`` and ``cache_specs`` assemble them), which
``repro_torch.sharding.Rules`` maps to mesh axes.

The attention core computes in float32 whatever the compute dtype
(logits, probabilities and the PV product), as the reference does, and
masks with ``-1e30``, not ``-inf``.  It is plain torch, as the reference's
is plain ``jnp`` outside any Pallas kernel, except the decode's core on the
card: a hand-written kernel with the same float32 arithmetic
(:func:`decode_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import gqa_decode

Params = Any  # nested dict of tensors

_NEG = -1e30  # the reference's mask fill


@dataclasses.dataclass
class Init:
    """Sequential parameter initializer over an explicit ``torch.Generator``.

    The same distributions as the reference's ``Init``: ``normal`` draws
    N(0, 1) in float32 and scales it, ``dense`` is N(0, 1/fan_in), norm
    gains are zeros.  The draws are the generator's, not
    ``jax.random``'s: the same seed gives other values than the reference,
    by design.
    """

    generator: torch.Generator
    device: torch.device

    def normal(self, shape, scale, dtype=torch.float32) -> torch.Tensor:
        x = torch.empty(shape, dtype=torch.float32, device=self.device)
        x.normal_(generator=self.generator)
        return x.mul_(float(scale)).to(dtype)

    def dense(self, shape, *, fan_in=None, dtype=torch.float32) -> torch.Tensor:
        fan_in = fan_in if fan_in is not None else shape[0]
        return self.normal(shape, 1.0 / np.sqrt(fan_in), dtype)

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def const(self, fn, shape, dtype=torch.float32) -> torch.Tensor:
        """``fn()`` (a deterministic tensor of ``shape``) in ``dtype`` on
        the device; it draws nothing from the generator."""
        out = fn().to(device=self.device, dtype=dtype).contiguous()
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.astype(dtype)`` of the reference: no copy when ``w`` already
    has it (the engine's compute-dtype copy of the weights)."""
    return w if w.dtype == dtype else w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) · (1 + γ)`` in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * gamma.float() + beta.float()).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embedding (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: ``(..., S, H, hd)``; positions: broadcastable to ``(..., S)``."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores (float32 inside)
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hkv, G, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,  # (B, Skv, Hkv, hd)
    *,
    causal: bool,
    window: int | None = None,
    logit_cap: float | None = None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Grouped-query attention, one query chunk at a time.

    Returns ``(B, Sq, Hkv, G, hd)``: query head ``h = kv·G + g`` reads KV
    head ``kv``.  ``window`` masks keys ``window`` or more positions behind
    the query; ``logit_cap`` is gemma-2's tanh softcap.  A query length
    that ``q_chunk`` does not divide is padded and sliced, as the
    reference does.
    """
    B, Sq, Hkv, G, hd = q.shape
    Skv = k.shape[1]
    scale = hd**-0.5
    q_chunk = min(q_chunk, Sq)
    Sq_orig = Sq
    pad = (-Sq) % q_chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        Sq = Sq + pad
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    kf, vf = k.float(), v.float()
    outs = []
    for c in range(Sq // q_chunk):
        qi = q[:, c * q_chunk:(c + 1) * q_chunk]
        logits = torch.einsum("bckgh,bskh->bkgcs", qi.float(), kf) * scale
        logits = softcap(logits, logit_cap)
        q_pos = c * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = torch.ones((q_chunk, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        logits = torch.where(mask, logits, _NEG)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bkgcs,bskh->bckgh", probs, vf).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq_orig]


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hkv, G, hd)
    k_cache: torch.Tensor,  # (B, Smax, Hkv, hd)
    v_cache: torch.Tensor,
    position: int | torch.Tensor,  # index of the token being produced: an int or a one-element int32 tensor
    *,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """One query token against its cache, keys masked to
    ``kv_pos <= position`` (and the window): :func:`plain_decode_attention`
    on the CPU (and on ``meta`` tensors), the hand-written kernel
    (``kernels/csrc/decode_attention.cu``) on the card, which reads the
    cache once, in place, with the same float32 arithmetic, and the
    position where it lies; only the order of its sums differs.  The kernel
    raises on what it does not take."""
    if q.is_cuda:
        return gqa_decode.decode_attention(q, k_cache, v_cache, position, window=window, logit_cap=logit_cap)
    return plain_decode_attention(q, k_cache, v_cache, position, window=window, logit_cap=logit_cap)


def plain_decode_attention(
    q: torch.Tensor,  # (B, 1, Hkv, G, hd)
    k_cache: torch.Tensor,  # (B, Smax, Hkv, hd)
    v_cache: torch.Tensor,
    position: int | torch.Tensor,
    *,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """One query token against the whole ``Smax`` cache, keys masked to
    ``kv_pos <= position`` (and the window), in float32 over a float32 copy
    of the cache; ``position`` an int or a one-element int32 tensor."""
    Smax = k_cache.shape[1]
    hd = q.shape[-1]
    scale = hd**-0.5
    logits = torch.einsum("bokgh,bskh->bkgos", q.float(), k_cache.float()) * scale
    logits = softcap(logits, logit_cap)
    kv_pos = torch.arange(Smax, dtype=torch.int32, device=q.device)
    mask = kv_pos <= position
    if window is not None:
        mask &= kv_pos > position - window
    logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgos,bskh->bokgh", probs, v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never all (B, S, V) logits at once)
# ---------------------------------------------------------------------------


def _chunk_nll(h, unemb, t, m, final_cap):
    """Σ over one chunk of ``(logsumexp − gold logit) · mask``, float32."""
    logits = softcap(h.float() @ unemb.float().T, final_cap)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return torch.sum((torch.logsumexp(logits, dim=-1) - gold) * m)


def chunked_softmax_xent(
    hidden: torch.Tensor,  # (B, S, d) final hidden states
    unemb: torch.Tensor,  # (V, d) unembedding
    targets: torch.Tensor,  # (B, S) integer ids
    mask: torch.Tensor,  # (B, S) {0, 1}
    *,
    s_chunk: int = 512,
    final_cap: float | None = None,
) -> torch.Tensor:
    """Mean CE loss over sequence chunks of the float32 logits:
    ``Σ nll / max(Σ mask, 1)``.  Under autograd each chunk runs under
    ``torch.utils.checkpoint``, so the backward holds one chunk's
    ``(B, s_chunk, V)`` logits at a time, recomputed, as the reference's
    ``lax.map`` does."""
    B, S, d = hidden.shape
    s_chunk = min(s_chunk, S)
    n = S // s_chunk
    assert S % s_chunk == 0
    targets = targets.long()
    mask = mask.to(torch.float32)
    losses = []
    for c in range(n):
        args = (hidden[:, c * s_chunk:(c + 1) * s_chunk], unemb,
                targets[:, c * s_chunk:(c + 1) * s_chunk], mask[:, c * s_chunk:(c + 1) * s_chunk], final_cap)
        losses.append(checkpoint(_chunk_nll, *args, use_reentrant=False)
                      if torch.is_grad_enabled() else _chunk_nll(*args))
    counts = torch.sum(mask.reshape(B, n, s_chunk), dim=(0, 2))
    return torch.sum(torch.stack(losses)) / torch.clamp(torch.sum(counts), min=1.0)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(emb.astype(np.float32), device=device)
