"""Causal grouped-query self-attention, as Qwen3 publishes it
(``modeling_qwen3.py``): projections without bias, Qwen3's RMSNorm of
each head's query and key (where the configuration has ``qk_norm``),
rotary positions on the two halves of a head (``rotate_half``, inverse
frequencies ``theta^(-2i/hd)``; where the configuration gives
``rope_theta``, as Jamba's gives none), query head ``h`` reading key head
``h // (H / K)``, softmax of ``q·k / sqrt(hd)`` over the positions at or
before the query's, and the output projection.  Float32 throughout.

Leaves: ``wq`` ``(d, H, hd)``, ``wk``/``wv`` ``(d, K, hd)``, ``wo`` ``(H,
hd, d)``; ``q_norm``/``k_norm`` ``(hd,)``, each RMSNorm's weight less one.
"""
import torch

matrices = ("wq", "wk", "wv", "wo")


def _hd(c):
    return int(c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"])


def params(c):
    d, H, K, hd = int(c["hidden_size"]), int(c["num_attention_heads"]), int(c["num_key_value_heads"]), _hd(c)
    std = float(c["initializer_range"])
    out = {"wq": ((d, H, hd), std), "wk": ((d, K, hd), std), "wv": ((d, K, hd), std), "wo": ((H, hd, d), std)}
    if c.get("qk_norm"):
        out["q_norm"] = ((hd,), 0.1)
        out["k_norm"] = ((hd,), 0.1)
    return out


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + g)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply(c, p, x, w):
    n, S, d = x.shape
    H, K, hd = int(c["num_attention_heads"]), int(c["num_key_value_heads"]), _hd(c)
    eps = float(c["rms_norm_eps"])
    q = (x @ w("wq", p["wq"]).reshape(d, H * hd)).view(n, S, H, hd)
    k = (x @ w("wk", p["wk"]).reshape(d, K * hd)).view(n, S, K, hd)
    v = (x @ w("wv", p["wv"]).reshape(d, K * hd)).view(n, S, K, hd)
    if c.get("qk_norm"):
        q, k = _rms(q, p["q_norm"], eps), _rms(k, p["k_norm"], eps)
    if c.get("rope_theta") is not None:
        inv = 1.0 / float(c["rope_theta"]) ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
        cos = torch.cat([ang, ang], -1).cos()[None, :, None, :]
        sin = torch.cat([ang, ang], -1).sin()[None, :, None, :]
        q, k = q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    o = torch.empty_like(q)
    for h in range(H):  # one head at a time: (n, S, S) scores
        s = (q[:, :, h] @ k[:, :, h].transpose(1, 2)) / hd**0.5
        s = s.masked_fill(~causal, float("-inf")).softmax(-1)
        o[:, :, h] = s @ v[:, :, h]
    return o.reshape(n, S, H * hd) @ w("wo", p["wo"]).reshape(H * hd, d)
