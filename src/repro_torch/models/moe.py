"""Mixture-of-Experts layer: GShard-style capacity dispatch.

Port of ``repro.models.moe``.  Top-k routing with grouped capacity: the
sequence is split into groups of ``moe_group_size`` tokens; each group
dispatches at most ``C = group·k·capacity_factor/E`` tokens per expert
through one-hot einsum dispatch and combine tensors, as the reference
does (a gather/scatter dispatch would sum in another order).

Routing runs in float32: the router product, softmax, top-k and the
renormalized gates.  The top k are taken stably by index (a stable sort
of ``-probs``), so a tie keeps the lower expert index first, as
``jax.lax.top_k`` does.  The expert products run in the compute dtype.

The reference's ``_pin_experts`` is a sharding constraint on the expert
dimension; the port's model takes no sharding rules, so it has no
counterpart here.

Beside the reference's aux values, :func:`apply_moe` returns the routing
decisions, ``routing`` ``(B, S, k)``: each token's experts in slot order,
-1 where its capacity queue dropped it; and the sums the data-parallel
train step needs to form the load-balance loss from the global batch's
means: ``prob_sum`` (the router probabilities summed over every token
slot, differentiable), ``route_sum`` (the routed one-hots summed) and
``slots`` (the token slots, pads included, that both means divide by).

Two port options (``configs.options``) serve a published model that
departs from this: ``moe_renormalize`` off uses the top-k gates as the
softmax gives them, and ``moe_dispatch="dropless"`` replaces the capacity
queues by a dispatch that drops nothing and holds no token twice.  Its
``T·k`` token-slots are sorted by expert on the device (stably, so each
expert's rows keep slot order), gathered, and run through the experts as
grouped products over the contiguous per-expert slices
(``torch._grouped_mm``, the slices' ends kept on the device), then put
back in slot order and summed under their gates.  Its shapes follow
``T·k`` alone and nothing reads a device value on the host, so a CUDA
graph captures it.

Every call counts ``moe.routed_slots`` (real tokens × k) and
``moe.expert_rows`` (the rows the expert products compute, the capacity
queues' empty places included) in ``core.spans``, under the span
``model.moe``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.options import option
from repro_torch.core import spans
from repro_torch.models.common import Init, cast

__all__ = ["apply_moe", "init_moe", "moe_specs"]


def init_moe(cfg, rng: Init) -> dict:
    """The router and the stacked experts.  ``w_gate`` and ``w_up`` take
    ``dense``'s default fan-in, their first dimension E, as the
    reference's do: N(0, 1/E), not N(0, 1/d)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "w_router": rng.dense((d, E)),
        "w_gate": rng.dense((E, d, f)),
        "w_up": rng.dense((E, d, f)),
        "w_down": rng.dense((E, f, d), fan_in=f),
    }


def moe_specs() -> dict:
    """The logical sharding of :func:`init_moe`'s tree."""
    return {
        "w_router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in float32: an index outside ``[0, n)``
    gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _top_k(cfg, probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's ``k`` experts, ties to the lower index, and their
    gates: renormalized to sum to one unless ``moe_renormalize`` is off."""
    idx = torch.argsort(-probs, dim=-1, stable=True)[..., :cfg.num_experts_per_token]
    gate = torch.gather(probs, -1, idx)
    if option(cfg, "moe_renormalize"):
        gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)
    return idx, gate


def apply_moe(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: ``(B, S, d)`` → ``(y, aux)``: the load-balance and router-z
    losses, the drop fraction, the routing and the sums of the module
    docstring."""
    with spans.span("model.moe"):
        if option(cfg, "moe_dispatch") == "dropless":
            return _dropless(cfg, p, x)
        return _capacity(cfg, p, x)


def _dropless(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The dropless dispatch of the module docstring."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_token
    T, dt = B * S, x.dtype
    xt = x.reshape(T, d)
    logits = xt.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    idx, gate = _top_k(cfg, probs)  # (T, k)
    flat = idx.reshape(T * k)  # slot t·k + i: token t's i-th expert
    order = torch.argsort(flat, stable=True)  # the slots, expert by expert
    ends = torch.searchsorted(flat[order], torch.arange(E, device=x.device), right=True).to(torch.int32)
    rows = xt.index_select(0, order // k)
    h = torch._grouped_mm(rows, cast(p["w_gate"], dt), offs=ends)
    u = torch._grouped_mm(rows, cast(p["w_up"], dt), offs=ends)
    del rows
    if torch.is_grad_enabled():
        h = F.silu(h) * u
    else:  # in place: a prefill's h and u are gigabytes each
        h = F.silu(h, inplace=True).mul_(u)
    del u
    y = torch._grouped_mm(h, cast(p["w_down"], dt), offs=ends)
    del h
    y = torch.empty_like(y).index_copy_(0, order, y)  # back in slot order
    out = torch.bmm(gate.to(dt)[:, None, :], y.view(T, k, d)).view(B, S, d)
    spans.count("moe.routed_slots", T * k)
    spans.count("moe.expert_rows", T * k)

    routed = _one_hot(idx, E).sum(1)  # (T, E)
    aux = {
        "moe_load_balance": E * torch.sum(probs.mean(0) * routed.mean(0)),
        "moe_router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_drop_fraction": torch.zeros((), device=x.device),
        "prob_sum": probs.sum(0),
        "route_sum": routed.sum(0),
        "slots": T,
        "routing": idx.reshape(B, S, k),
    }
    return out, aux


def _capacity(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """GShard's grouped capacity dispatch (the module docstring)."""
    B0, S0, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_token
    # decode (S == 1): the batch becomes one sequence of groups, else
    # capacity degenerates to one slot an expert a token
    if S0 == 1 and B0 > 1:
        x = x.reshape(1, B0, d)
    B, S, _ = x.shape
    g = min(cfg.moe_group_size, S)
    S_real = S
    pad = (-S) % g
    if pad:  # pads at the end keep the real tokens' queue positions
        x = F.pad(x, (0, 0, 0, pad))
        S += pad
    nG = S // g
    valid = (torch.arange(S, device=x.device) < S_real).reshape(1, nG, g)
    cap = max(int(g * k * cfg.moe_capacity_factor / E), 1)
    dt = x.dtype

    xg = x.reshape(B, nG, g, d)
    logits = torch.einsum("bngd,de->bnge", xg.float(), p["w_router"].float())
    probs = torch.softmax(logits, dim=-1)
    idx, gate = _top_k(cfg, probs)  # (B, nG, g, k)

    onehot = _one_hot(idx, E) * valid[..., None, None].to(torch.float32)  # (B, nG, g, k, E)
    # each (token, slot)'s place in its expert's queue: slot 0 first, then
    # tokens in sequence order within a slot
    flat = onehot.movedim(3, 2).reshape(B, nG, k * g, E)
    pos_flat = torch.cumsum(flat, dim=2) - flat  # exclusive prefix count
    pos = pos_flat.reshape(B, nG, k, g, E).movedim(2, 3)  # (B, nG, g, k, E)
    kept = onehot * (pos < cap).to(torch.float32)

    combine_w = gate[..., None] * kept
    pos_idx = torch.sum(pos * onehot, dim=-1)  # (B, nG, g, k)
    combine = torch.einsum("bngke,bngkc->bngec", combine_w, _one_hot(pos_idx, cap))
    dispatch = (combine > 0).to(dt)  # (B, nG, g, E, C)

    x_e = torch.einsum("bngec,bngd->bnecd", dispatch, xg.to(dt))
    h_g = torch.einsum("bnecd,edf->bnecf", x_e, cast(p["w_gate"], dt))
    h_u = torch.einsum("bnecd,edf->bnecf", x_e, cast(p["w_up"], dt))
    y_e = torch.einsum("bnecf,efd->bnecd", F.silu(h_g) * h_u, cast(p["w_down"], dt))
    y = torch.einsum("bngec,bnecd->bngd", combine.to(dt), y_e)

    # aux: GShard load balance and router z-loss
    routed = onehot[..., 0, :] if k == 1 else onehot.sum(3)  # (B, nG, g, E)
    me = torch.mean(probs, dim=(0, 1, 2))  # mean router probability
    ce = torch.mean(torch.sum(routed, dim=-2) / g, dim=(0, 1))  # fraction routed
    aux = {
        "moe_load_balance": E * torch.sum(me * ce),
        "moe_router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_drop_fraction": 1.0 - torch.sum(kept) / torch.clamp(torch.sum(onehot), min=1.0),
        "prob_sum": torch.sum(probs, dim=(0, 1, 2)),
        "route_sum": torch.sum(routed, dim=(0, 1, 2)),
        "slots": B * nG * g,
        "routing": torch.where(kept.sum(-1) > 0, idx, -1).reshape(B, S, k)[:, :S_real].reshape(B0, S0, k),
    }
    spans.count("moe.routed_slots", B * S_real * k)
    spans.count("moe.expert_rows", B * nG * E * cap)
    y = y.reshape(B, S, d)[:, :S_real]
    return y.reshape(B0, S0, d), aux
