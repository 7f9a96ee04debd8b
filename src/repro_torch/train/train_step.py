"""Train step: autograd + clip (+compress) + AdamW, microbatched.

Port of ``repro.train.train_step``.  ``step(params, opt_state, batch) →
(params', opt_state', metrics)`` stays functional: the inputs are left as
they are and every metric is a 0-d tensor where the parameters lie, so a
step reads nothing back to the host.  Gradients come from
``torch.autograd.grad`` over the tree's leaves.

The cast rule is the reference's: every float32 leaf with ``ndim > 1`` —
decided on the *stacked* leaf, so the ``(repeats, d)`` norm gains count —
is cast to the compute dtype inside the differentiated function, and its
gradient comes back through the cast as float32.  A tied embedding cast to
bfloat16 serves as both the lookup and the unembedding of the loss; the
gradients of both uses meet in bfloat16 before the cast back, as in the
reference.

Data parallelism: on a mesh whose ``Rules`` put ``act_batch`` on mesh
axes, each rank runs the step on its own share of the batch
(``data.shard_batch``), and the parameters stay replicated.  Each
microbatch's loss on a rank is that rank's share of the loss the
reference computes on the whole microbatch, so that the loss and the
gradients summed over those axes are the whole microbatch's, whatever
the ranks' mask counts:

- cross-entropy: the rank's masked mean times ``max(c_r, 1) / max(C, 1)``,
  ``c_r`` its mask count and ``C`` the count all-reduced over the ranks;
- MoE load balance, ``E·Σ_e me_e·ce_e``, a product of two batch means:
  each MoE layer's sums of router probabilities and of routed one-hots
  and its token slots are all-reduced (detached), and the rank forms
  ``me`` from the global sum with its own sum's gradient, so that the
  ranks' gradients add up to the global one; its value counts once;
- router z-loss, a mean over token slots: weighted by the rank's share of
  the slots.

One all-reduce of the counts and sums a microbatch, after its forward;
then one all-reduce (a sum) of the loss, the metrics and the float32
gradients before clipping.  FSDP and tensor-parallel placement of the
parameters (``Rules.placements``) are not applied here.

``opt_state`` = {"m", "v", "step"} (+ "residual" when compression is on).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_tensor
from repro_torch.models.common import chunked_softmax_xent
from repro_torch.models.model import forward_hidden, loss_fn, moe_layer_count
from repro_torch.optim import (
    CompressionConfig,
    OptimizerConfig,
    adamw_update,
    clip_grads,
    compress_grads,
    init_opt_state,
    init_residual,
)
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["make_grad_fn", "make_opt_state", "make_train_step"]


def make_opt_state(params, opt_cfg, comp_cfg: CompressionConfig | None = None) -> dict:
    state = init_opt_state(params, opt_cfg)
    if comp_cfg is not None and comp_cfg.enabled:
        state["residual"] = init_residual(params)
    return state


def _all_reduce_sum(tensors: list, mesh, axes: tuple[str, ...]) -> list:
    """The sum of each float32 tensor over the mesh ``axes``: one flat
    all-reduce per axis."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for ax in axes:
        dist.all_reduce(flat, group=mesh.get_group(ax))
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _rank_share(cfg, params, batch: dict, mesh, axes: tuple[str, ...]):
    """This rank's share of the loss of the microbatch that all ranks of
    ``axes`` hold together (module docstring) → ``(objective, loss share,
    metric shares)``: the gradients of ``objective`` and the shares sum
    over the ranks to the whole microbatch's."""
    hidden, aux = forward_hidden(cfg, params, batch)
    dev = hidden.device
    mask = as_tensor(batch["mask"], dev).to(torch.float32)
    ce = chunked_softmax_xent(
        hidden, params["embed"] if cfg.tie_embeddings else params["unembed"],
        as_tensor(batch["targets"], dev), mask, s_chunk=cfg.loss_chunk, final_cap=cfg.final_softcap,
    )
    layers = aux.get("moe_layers", [])
    count = torch.sum(mask).reshape(1)
    slots = torch.tensor([float(a["slots"]) for a in layers], dtype=torch.float32, device=dev)
    local = [count, slots] + [a["prob_sum"].detach() for a in layers] + [a["route_sum"] for a in layers]
    total = _all_reduce_sum(local, mesh, axes)
    ranks = 1
    for ax in axes:
        ranks *= mesh.size(mesh.mesh_dim_names.index(ax))
    ce_share = ce * (torch.clamp(count, min=1.0) / torch.clamp(total[0], min=1.0))[0]
    lb = zl_share = torch.zeros((), dtype=torch.float32, device=dev)
    n = len(layers)
    for i, a in enumerate(layers):
        slots_all = total[1][i]
        prob_sum, route_sum = total[2 + i], total[2 + n + i]
        me = (prob_sum + (a["prob_sum"] - a["prob_sum"].detach())) / slots_all
        lb = lb + cfg.num_experts * torch.sum(me * (route_sum / slots_all))
        zl_share = zl_share + a["moe_router_z"] * (slots[i] / slots_all)
    n_layers = moe_layer_count(cfg)
    lb, zl_share = lb / n_layers, zl_share / n_layers
    objective = ce_share + cfg.moe_aux_weight * lb + cfg.moe_z_weight * zl_share
    lb_share = lb.detach() / ranks  # the same on every rank: counted once in the sum
    loss_share = ce_share.detach() + cfg.moe_aux_weight * lb_share + cfg.moe_z_weight * zl_share.detach()
    return objective, loss_share, {"ce": ce_share.detach(), "moe_load_balance": lb_share,
                                   "moe_router_z": zl_share.detach()}


def make_grad_fn(cfg: ModelConfig, rules=None, mesh=None) -> Callable:
    """The train step's differentiated loss alone: ``grad_fn(params, batch)
    → ((loss, metrics), grads)``, ``grads`` a tree of the parameters'
    structure and dtypes (float32 for the float32 leaves), under the cast
    rule of the module docstring.  On a mesh whose ``rules`` put
    ``act_batch`` on mesh axes, ``batch`` is this rank's share and the
    loss, the metrics and the gradients are this rank's shares, whose sums
    over those axes are the whole batch's (module docstring)."""

    compute_dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    axes = () if rules is None or mesh is None else rules.batch_axes()

    def cast(p):
        return p.to(compute_dt) if p.dtype == torch.float32 and p.dim() > 1 else p

    def grad_fn(params, microbatch):
        with torch.enable_grad():
            xs = tree_map(lambda p: p.detach().requires_grad_(), params)
            if axes:
                objective, loss, m = _rank_share(cfg, tree_map(cast, xs), microbatch, mesh, axes)
            else:
                objective, m = loss_fn(cfg, tree_map(cast, xs), microbatch)
                loss = objective
            flat = leaves(xs)
            gs = torch.autograd.grad(objective, flat, allow_unused=True)
        grads = unflatten(xs, [torch.zeros_like(x) if g is None else g for x, g in zip(flat, gs)])
        return (loss.detach(), {k: v.detach() for k, v in m.items()}), grads

    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    rules=None,
    comp_cfg: CompressionConfig | None = None,
    mesh=None,
    telemetry_axes: tuple[str, ...] = (),
) -> Callable:
    """Returns step(params, opt_state, batch) → (params', opt_state', metrics).

    ``batch`` leaves carry a leading (accum,) dim when grad_accum > 1; on a
    mesh they are this rank's share (``data.shard_batch``), and the
    metrics and the update are the whole batch's on every rank.
    """

    grad_fn = make_grad_fn(cfg, rules, mesh)
    batch_axes = () if rules is None or mesh is None else rules.batch_axes()

    def step(params, opt_state, batch):
        if opt_cfg.grad_accum > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(opt_cfg.grad_accum):
                (loss, _), g = grad_fn(params, {k: v[i] for k, v in batch.items()})
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
                loss_sum = loss_sum + loss
                del g
            grads = tree_map(lambda g: g / opt_cfg.grad_accum, grads)
            metrics = {"loss": loss_sum / opt_cfg.grad_accum}
        else:
            (loss, m), grads = grad_fn(params, batch)
            metrics = {"loss": loss, **m}

        if batch_axes:  # every rank's share summed: the whole batch's
            names, flat = list(metrics), leaves(grads)
            reduced = _all_reduce_sum([metrics[k].reshape(1) for k in names] + [g.to(torch.float32) for g in flat],
                                      mesh, batch_axes)
            metrics = {k: r.reshape(()) for k, r in zip(names, reduced)}
            grads = unflatten(grads, [r.to(g.dtype) for g, r in zip(flat, reduced[len(names):])])

        grads, clip_m = clip_grads(grads, opt_cfg, mesh=mesh, axis_names=telemetry_axes)
        metrics.update(clip_m)

        new_state = {}
        if comp_cfg is not None and comp_cfg.enabled:
            grads, new_state["residual"], cm = compress_grads(
                grads, opt_state["residual"], comp_cfg,
                mesh=mesh, axis_names=telemetry_axes,
            )
            metrics.update(cm)

        inner = {k: opt_state[k] for k in ("m", "v", "step")}
        new_params, new_inner, opt_m = adamw_update(grads, inner, params, opt_cfg)
        new_state.update(new_inner)
        metrics.update(opt_m)
        return new_params, new_state, metrics

    return step
