"""Mamba (S6) mixer for the Jamba hybrid: a chunked parallel scan.

Port of ``repro.models.mamba``.  The recurrence is ``h_t = a_t ⊙ h_{t-1}
+ b_t`` with ``a_t = exp(Δ_t A)`` and ``b_t = Δ_t B_t x_t``.  The sequence
runs in chunks of ``cfg.mamba_chunk`` (and a shorter tail), carrying the
float32 ``(B, d_inner, d_state)`` state between them; inside a chunk an
associative scan with ``combine((a₁, b₁), (a₂, b₂)) = (a₁a₂, a₂b₁ + b₂)``
takes log-depth steps, in the odd/even recursion of
``jax.lax.associative_scan``, so that under ``mamba_scan_dtype=
"bfloat16"`` every combine rounds as the reference's does.  Only one
chunk's ``(B, chunk, d_inner, d_state)`` tensors exist at a time; under a
``remat_policy`` other than ``"none"`` each chunk runs under
``torch.utils.checkpoint`` while autograd records, as the reference
wraps it in ``jax.checkpoint``.

Under the port option ``mamba_dbc_norm`` (``configs.options``, Jamba's
published mixer) Δ's low-rank input, B and C each pass an RMSNorm
(``dt_norm``, ``b_norm``, ``c_norm``, weights stored less one) between the
``w_dbc`` product and ``w_dt`` and the scan, in prefill and decode alike.

Dtypes follow the reference's promotion: ``A_log``, ``D`` and
``dt_bias`` are used as they arrive (bfloat16 under the train step's
cast rule, which casts their stacked leaves), ``-exp(A_log)`` is computed
in that dtype, and a float32 operand promotes the product.

The scan is plain torch, as the reference's is plain ``jnp`` outside
Pallas.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.options import option
from repro_torch.core import spans
from repro_torch.models.common import Init, cast, rms_norm

__all__ = [
    "apply_mamba", "decode_mamba_step", "init_mamba", "init_mamba_cache", "mamba_cache_specs", "mamba_specs",
    "prefill_mamba",
]

_NORMS = ("dt_norm", "b_norm", "c_norm")  # the mamba_dbc_norm leaves: Δ's input, B, C


def init_mamba(cfg, rng: Init) -> dict:
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    K = cfg.mamba_d_conv
    dt_rank = max(d // 16, 1)
    p = {
        "wx": rng.dense((d, d_in)),
        "wz": rng.dense((d, d_in)),
        "conv_w": rng.dense((d_in, K), fan_in=K),
        "conv_b": rng.zeros((d_in,)),
        "w_dbc": rng.dense((d_in, dt_rank + 2 * n)),
        "w_dt": rng.dense((dt_rank, d_in)),
        "dt_bias": rng.normal((d_in,), 0.1),
        "A_log": rng.const(
            lambda: torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=rng.device)[None, :]
                              .expand(d_in, n)),
            (d_in, n),
        ),
        "D": rng.ones((d_in,)),
        "w_out": rng.dense((d_in, d), fan_in=d_in),
    }
    if option(cfg, "mamba_dbc_norm"):
        p.update(zip(_NORMS, (rng.zeros((dt_rank,)), rng.zeros((n,)), rng.zeros((n,)))))
    return p


def mamba_specs(cfg) -> dict:
    """The logical sharding of :func:`init_mamba`'s tree."""
    specs = {
        "wx": ("embed", "mamba_inner"),
        "wz": ("embed", "mamba_inner"),
        "conv_w": ("mamba_inner", None),
        "conv_b": ("mamba_inner",),
        "w_dbc": ("mamba_inner", None),
        "w_dt": (None, "mamba_inner"),
        "dt_bias": ("mamba_inner",),
        "A_log": ("mamba_inner", None),
        "D": ("mamba_inner",),
        "w_out": ("mamba_inner", "embed"),
    }
    if option(cfg, "mamba_dbc_norm"):
        specs.update((k, (None,)) for k in _NORMS)
    return specs


def _split_dbc(cfg, dbc):
    dt_rank = max(cfg.d_model // 16, 1)
    n = cfg.mamba_d_state
    return dbc[..., :dt_rank], dbc[..., dt_rank:dt_rank + n], dbc[..., dt_rank + n:]


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: ``(B, S, d_in)``; w: ``(d_in, K)``: the causal depthwise
    convolution (a grouped ``conv1d`` over a left padding of K − 1)."""
    K = w.shape[-1]
    xt = F.pad(x.transpose(1, 2), (K - 1, 0))  # (B, d_in, K - 1 + S)
    return F.conv1d(xt, w[:, None, :], groups=w.shape[0]).transpose(1, 2) + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_inputs(cfg, p, x1):
    """Δ, B, C and A from the post-conv activations x1 ``(..., d_in)``."""
    dt_x, Bc, Cc = _split_dbc(cfg, x1 @ cast(p["w_dbc"], x1.dtype))
    if option(cfg, "mamba_dbc_norm"):
        dt_x, Bc, Cc = (rms_norm(t, p[k], cfg.norm_eps) for t, k in zip((dt_x, Bc, Cc), _NORMS))
    dt = _softplus((dt_x @ cast(p["w_dt"], x1.dtype)).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (d_in, n)
    return dt, Bc.float(), Cc.float(), A


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along dim 1 (``a`` may hold one more)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def associative_scan(elems: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` along dim 1, in the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan those, then
    combine each odd prefix with the next element."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _chunk(cfg, p, scan_dt, dt_, h, x1_c):
    """One chunk: ``(h (B, d_in, n) float32, x1_c (B, c, d_in))`` →
    ``(the chunk's last state, y (B, c, d_in))``."""
    dt, Bc, Cc, A = _ssm_inputs(cfg, p, x1_c)  # dt (B, c, d_in)
    da = torch.exp(dt[..., None] * A).to(scan_dt)  # (B, c, d_in, n)
    db = (dt[..., None] * Bc[:, :, None, :] * x1_c.float()[..., None]).to(scan_dt)
    cum_a, cum_b = associative_scan((da, db))
    h_all = cum_a.float() * h[:, None] + cum_b.float()  # (B, c, d_in, n) float32
    y = torch.einsum("bcin,bcn->bci", h_all, Cc) + p["D"] * x1_c.float()
    return h_all[:, -1], y.to(dt_)


def _mamba(cfg, p, x: torch.Tensor, h0: torch.Tensor | None):
    """``(y, final state, the pre-conv activations (B, S, d_in))``."""
    B, S, d = x.shape
    d_in = cfg.mamba_expand * d
    dt_ = x.dtype
    c = min(cfg.mamba_chunk, S)
    n_full = S // c

    x0 = x @ cast(p["wx"], dt_)
    z = x @ cast(p["wz"], dt_)
    x1 = F.silu(_causal_depthwise_conv(x0, cast(p["conv_w"], dt_), cast(p["conv_b"], dt_)))
    h = torch.zeros((B, d_in, cfg.mamba_d_state), dtype=torch.float32, device=x.device) if h0 is None else h0
    scan_dt = torch.bfloat16 if cfg.mamba_scan_dtype == "bfloat16" else torch.float32

    def chunk(h, x1_c):
        if cfg.remat_policy != "none" and torch.is_grad_enabled():
            return checkpoint(_chunk, cfg, p, scan_dt, dt_, h, x1_c, use_reentrant=False)
        return _chunk(cfg, p, scan_dt, dt_, h, x1_c)

    ys = []
    with spans.span("mamba.scan"):
        for i in range(n_full):
            h, y = chunk(h, x1[:, i * c:(i + 1) * c])
            ys.append(y)
        if S > n_full * c:  # the tail (e.g. a prefill of S + 1 tokens)
            h, y = chunk(h, x1[:, n_full * c:])
            ys.append(y)
        y = torch.cat(ys, dim=1)
    y = y * F.silu(z)
    return y @ cast(p["w_out"], dt_), h, x0


def apply_mamba(cfg, p, x: torch.Tensor, h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: ``(B, S, d)`` → ``(y, final state (B, d_in, n) float32)``; whole
    chunks of ``cfg.mamba_chunk``, then a tail that is not a whole chunk."""
    y, h, _ = _mamba(cfg, p, x, h0)
    return y, h


def prefill_mamba(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """:func:`apply_mamba` from a zero state → ``(y, {"h": the final state,
    "conv": the last K − 1 pre-conv rows})``, the decode cache's contents."""
    y, h, x0 = _mamba(cfg, p, x, None)
    return y, {"h": h, "conv": x0[:, -(cfg.mamba_d_conv - 1):]}


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    """``h`` ``(batch, d_in, n)`` float32 whatever ``dtype``; ``conv``, the
    last K − 1 pre-conv rows, ``(batch, K − 1, d_in)`` in ``dtype``."""
    d_in = cfg.mamba_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, d_in, cfg.mamba_d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, d_in), dtype=dtype, device=device),
    }


def mamba_cache_specs() -> dict:
    """The logical sharding of :func:`init_mamba_cache`'s tree."""
    return {"h": ("batch_kv", "mamba_inner", None), "conv": ("batch_kv", None, "mamba_inner")}


def decode_mamba_step(cfg, p, x: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
    """x: ``(B, 1, d)`` → ``(y, new cache)``: an O(1) state update."""
    dt_ = x.dtype
    x1 = (x @ cast(p["wx"], dt_))[:, 0]
    z = (x @ cast(p["wz"], dt_))[:, 0]
    window = torch.cat([cache["conv"], x1[:, None].to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bki,ik->bi", window.to(dt_), cast(p["conv_w"], dt_)) + cast(p["conv_b"], dt_)
    x1 = F.silu(conv_out)
    dt, Bc, Cc, A = _ssm_inputs(cfg, p, x1)
    da = torch.exp(dt[..., None] * A)  # (B, d_in, n)
    db = dt[..., None] * Bc[:, None, :] * x1.float()[..., None]
    h = da * cache["h"] + db
    y = torch.einsum("bin,bn->bi", h, Cc) + p["D"] * x1.float()
    y = y.to(dt_) * F.silu(z)
    out = (y @ cast(p["w_out"], dt_))[:, None]
    return out, {"h": h, "conv": window[:, 1:]}
