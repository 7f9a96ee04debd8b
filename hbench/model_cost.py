"""Frozen operation and byte counts of a served model, for the per-layer
shares of the H100's peaks (``metrics/*.serve.py``).

They count the model's own arithmetic, whatever implements it, from the
configuration's published sizes (the keys of ``configs/<config>.json``,
Hugging Face's names) and its ``pattern`` of layer kinds:

- a token costs ``2 · P`` operations, ``P`` the matrix parameters it is
  multiplied by: the attention projections, the feed-forward, the
  router and the ``k`` experts it is routed to, Mamba's projections and
  its depthwise convolution, and the unembedding wherever logits are
  needed (a prefill needs them at the last position only; the embedding
  is a gather and costs nothing);
- causal attention adds ``2 · 2 · ctx · H · hd`` a query and layer: the
  scores and the weighted sum over the ``ctx`` positions it sees, so a
  prefill of ``S`` tokens adds ``4 · H · hd · S(S + 1)/2`` a sequence
  and layer;
- a Mamba layer adds ``6 · d_inner · d_state`` a token: the input term,
  the state update and the readout of the selective scan;
- a decode step must read every matrix parameter once in the served
  dtype (the experts that the batch can reach: ``min(E, B · k)`` of
  them), the keys and values of every attention layer up to the step's
  position, and Mamba's state and convolution tail, read and written.

The program's own counts may change; this copy is the benchmark's
yardstick; ``cost.py`` turns bytes into the least time.
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB data sheet: dense bfloat16 operations a second
PEAK_BF16_FLOPS = 989e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(c: dict) -> int:
    return int(c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"])


def layer_kinds(c: dict) -> list[str]:
    """Every layer's kind, in order: ``pattern`` repeated to the depth."""
    pattern, depth = list(c["pattern"]), int(c["num_hidden_layers"])
    if depth % len(pattern):
        raise ValueError(f"{depth} layers are no whole number of periods of {pattern}")
    return pattern * (depth // len(pattern))


def _d_inner(c: dict) -> int:
    return int(c["mamba_expand"]) * int(c["hidden_size"])


def part_params(c: dict, part: str, routed: int | None = None) -> int:
    """Matrix parameters of one layer's ``part`` that a token is
    multiplied by; of the MoE, the router and ``routed`` experts (default
    the ``k`` a token is routed to)."""
    d, f = int(c["hidden_size"]), int(c["intermediate_size"])
    if part == "attn":
        H, K, hd = int(c["num_attention_heads"]), int(c["num_key_value_heads"]), head_dim(c)
        return d * H * hd + 2 * d * K * hd + H * hd * d
    if part == "mlp":
        return 3 * d * f
    if part == "moe":
        k = int(c["num_experts_per_tok"]) if routed is None else routed
        return d * int(c["num_experts"]) + k * 3 * d * f
    if part == "mamba":
        di, n, K, r = _d_inner(c), int(c["mamba_d_state"]), int(c["mamba_d_conv"]), int(c["mamba_dt_rank"])
        return 2 * d * di + di * K + di * (r + 2 * n) + r * di + di * d
    raise ValueError(f"no count for a layer part {part!r}")


def _parts(c: dict):
    for kind in layer_kinds(c):
        yield from kind.split("+")


def token_params(c: dict) -> int:
    """Matrix parameters a token of the layers is multiplied by (no
    unembedding)."""
    return sum(part_params(c, p) for p in _parts(c))


def _attention_width(c: dict) -> int:
    return int(c["num_attention_heads"]) * head_dim(c)


def _scan_flops(c: dict) -> int:
    """A token's selective-scan operations over every Mamba layer."""
    return sum(6 * _d_inner(c) * int(c["mamba_d_state"]) for p in _parts(c) if p == "mamba")


def _attn_layers(c: dict) -> int:
    return sum(1 for p in _parts(c) if p == "attn")


def unembed_params(c: dict) -> int:
    return int(c["vocab_size"]) * int(c["hidden_size"])


def prefill_flops(c: dict, batch: int, prompt: int) -> float:
    """A prefill of ``batch`` prompts of ``prompt`` tokens, logits at
    the last position."""
    per_seq = 2.0 * prompt * token_params(c) + prompt * _scan_flops(c)
    per_seq += 4.0 * _attention_width(c) * _attn_layers(c) * prompt * (prompt + 1) / 2
    return batch * (per_seq + 2.0 * unembed_params(c))


def decode_flops(c: dict, batch: int, pos: int) -> float:
    """One decode step of ``batch`` tokens at position ``pos`` (each sees
    ``pos + 1`` positions)."""
    per_tok = 2.0 * (token_params(c) + unembed_params(c)) + _scan_flops(c)
    per_tok += 4.0 * _attention_width(c) * _attn_layers(c) * (pos + 1)
    return batch * per_tok


def turn_flops(c: dict, batch: int, prompt: int, new: int) -> float:
    """A turn that returns ``new`` tokens a prompt: the prefill (the
    first token) and ``new - 1`` decode steps at positions ``prompt`` to
    ``prompt + new - 2``."""
    return prefill_flops(c, batch, prompt) + sum(decode_flops(c, batch, prompt + k) for k in range(new - 1))


def decode_bytes(c: dict, batch: int, pos: int, dtype: str) -> float:
    """What a decode step of ``batch`` tokens at position ``pos`` must
    read (and Mamba's state, write), in bytes, weights and cache in
    ``dtype``."""
    w = DTYPE_BYTES[dtype]
    params = unembed_params(c)
    state = 0.0
    for p in _parts(c):
        if p == "moe":
            params += part_params(c, p, routed=min(int(c["num_experts"]), batch * int(c["num_experts_per_tok"])))
        else:
            params += part_params(c, p)
        if p == "attn":
            state += 2.0 * batch * (pos + 1) * int(c["num_key_value_heads"]) * head_dim(c) * w
        if p == "mamba":
            di = _d_inner(c)
            state += 2.0 * batch * (di * int(c["mamba_d_state"]) * 4 + (int(c["mamba_d_conv"]) - 1) * di * w)
    return params * w + state

