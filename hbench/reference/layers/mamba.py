"""The Mamba-1 mixer as Jamba publishes it (``JambaMambaMixer`` in
``modeling_jamba.py``, its slow path), sequential and in float32:

- ``in_proj`` without bias, split into the input ``x`` and the gate ``z``;
- a causal depthwise convolution of width ``mamba_d_conv`` over ``x``,
  with bias where ``mamba_conv_bias``, then SiLU;
- ``x_proj`` without bias into Δ's low-rank input (``mamba_dt_rank``), B
  and C (``mamba_d_state`` each), each through its own RMSNorm
  (``dt_layernorm``, ``b_layernorm``, ``c_layernorm``, eps
  ``rms_norm_eps``);
- Δ = softplus(``dt_proj`` with bias), A = −exp(``A_log``);
- one token at a time: ``h = exp(Δ A) h + Δ B x``, ``y = C·h + D x``;
- ``y · silu(z)``, then ``out_proj`` without bias.

Leaves, in the program's layout: ``wx``/``wz`` ``(d, d_inner)`` (the two
halves of ``in_proj``), ``conv_w`` ``(d_inner, K)``, ``conv_b``, ``w_dbc``
``(d_inner, r + 2n)``, ``w_dt`` ``(r, d_inner)``, ``dt_bias``, ``A_log``
``(d_inner, n)``, ``D``, ``w_out`` ``(d_inner, d)``; ``dt_norm`` ``(r,)``,
``b_norm``/``c_norm`` ``(n,)``, each RMSNorm's weight less one.  Jamba's
projections carry no bias (``mamba_proj_bias`` false); a configuration
with them is refused.
"""
import math

import torch
import torch.nn.functional as F

matrices = ("wx", "wz", "w_dbc", "w_dt", "w_out")
GAIN_STD = 0.1  # a norm weight's spread about one, as reference/model.py draws every norm's


def _sizes(c):
    d = int(c["hidden_size"])
    return d, int(c["mamba_expand"]) * d, int(c["mamba_d_state"]), int(c["mamba_d_conv"]), int(c["mamba_dt_rank"])


def params(c):
    if c.get("mamba_proj_bias"):
        raise ValueError("a Mamba mixer with projection biases is not Jamba's")
    d, di, n, K, r = _sizes(c)
    s = float(c["initializer_range"])
    conv = 1.0 / math.sqrt(3 * K)  # the std of PyTorch's conv init, U(±1/√K)
    out = {"wx": ((d, di), s), "wz": ((d, di), s), "conv_w": ((di, K), conv)}
    if c.get("mamba_conv_bias", True):
        out["conv_b"] = ((di,), conv)
    out.update({
        "w_dbc": ((di, r + 2 * n), s), "w_dt": ((r, di), 1.0 / math.sqrt(3 * r)),  # U(±r^-1/2): Mamba's dt_proj
        "dt_bias": ((di,), 0.1), "A_log": ((di, n), 0.5), "D": ((di,), 1.0), "w_out": ((di, d), s),
        "dt_norm": ((r,), GAIN_STD), "b_norm": ((n,), GAIN_STD), "c_norm": ((n,), GAIN_STD),
    })
    return out


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + g)


def apply(c, p, x, w):
    _, di, n, K, r = _sizes(c)
    eps = float(c["rms_norm_eps"])
    S = x.shape[1]
    xi = x @ w("wx", p["wx"])
    z = x @ w("wz", p["wz"])
    pad = F.pad(xi, (0, 0, K - 1, 0))
    xi = sum(pad[:, k:k + S] * p["conv_w"][:, k] for k in range(K))
    xi = F.silu(xi + p["conv_b"] if "conv_b" in p else xi)
    dt, B, C = (xi @ w("w_dbc", p["w_dbc"])).split([r, n, n], dim=-1)
    dt, B, C = _rms(dt, p["dt_norm"], eps), _rms(B, p["b_norm"], eps), _rms(C, p["c_norm"], eps)
    dt = F.softplus(dt @ w("w_dt", p["w_dt"]) + p["dt_bias"])
    decay = torch.exp(dt[..., None] * -torch.exp(p["A_log"]))  # exp(Δ A), (n, S, d_inner, d_state)
    inject = (dt * xi)[..., None] * B[:, :, None, :]  # Δ B x
    h = x.new_zeros(x.shape[0], di, n)
    hs = []
    for t in range(S):
        h = decay[:, t] * h + inject[:, t]
        hs.append(h)
    y = torch.einsum("bsin,bsn->bsi", torch.stack(hs, 1), C) + p["D"] * xi
    return (y * F.silu(z)) @ w("w_out", p["w_out"])
