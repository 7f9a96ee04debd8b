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
(``data.shard_batch``); the loss and the float32 gradients are
all-reduced to their mean over those axes before clipping, and the
parameters stay replicated.  With equal mask counts on every share (the
synthetic stream's all-ones mask) the mean of the shares' losses is the
global batch's.  FSDP and tensor-parallel placement of the parameters
(``Rules.placements``) are not applied here.

``opt_state`` = {"m", "v", "step"} (+ "residual" when compression is on).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
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


def _all_reduce_mean(tensors: list, mesh, axes: tuple[str, ...]) -> list:
    """The mean of each float32 tensor over the mesh ``axes``: one flat
    all-reduce (sum) per axis, then one division by their ranks."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    n = 1
    for ax in axes:
        dist.all_reduce(flat, group=mesh.get_group(ax))
        n *= mesh.size(mesh.mesh_dim_names.index(ax))
    flat /= n
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_grad_fn(cfg: ModelConfig) -> Callable:
    """The train step's differentiated loss alone: ``grad_fn(params, batch)
    → ((loss, metrics), grads)``, ``grads`` a tree of the parameters'
    structure and dtypes (float32 for the float32 leaves), under the cast
    rule of the module docstring."""

    compute_dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def cast(p):
        return p.to(compute_dt) if p.dtype == torch.float32 and p.dim() > 1 else p

    def grad_fn(params, microbatch):
        with torch.enable_grad():
            xs = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, m = loss_fn(cfg, tree_map(cast, xs), microbatch)
            flat = leaves(xs)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
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
    mesh they are this rank's share (``data.shard_batch``).
    """

    grad_fn = make_grad_fn(cfg)
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

        if batch_axes:
            flat = leaves(grads)
            reduced = _all_reduce_mean([metrics["loss"].reshape(1)] + [g.to(torch.float32) for g in flat],
                                       mesh, batch_axes)
            metrics["loss"] = reduced[0].reshape(())
            grads = unflatten(grads, [r.to(g.dtype) for g, r in zip(flat, reduced[1:])])

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
