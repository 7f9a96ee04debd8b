"""Model assembly: pattern-based layer stacks over stacked repeats.

Port of ``repro.models.model`` for every layer kind of the configs
(``attn+mlp``, ``local+mlp``, ``global+mlp``, ``attn+moe``,
``mamba+mlp``, ``mamba+moe``, ``rwkv``, ``attn+cross+mlp``): GQA and MHA,
qk-norm, attention and final softcaps, the sliding window,
``embed_scale``, tied embeddings, the capacity-routed experts
(``models.moe``), the chunked selective scan (``models.mamba``), the
RWKV-6 time and channel mix (``models.rwkv``), the whisper encoder with
the decoder's cross-attention, and the vision frontend's patch
embeddings prepended to the token stream.  A model is a repeating
``pattern`` of layer kinds whose parameters are stacked over ``repeats``
on a leading axis; the reference's ``jax.lax.scan`` over repeats is a
Python loop here, repeat ``r`` then pattern position ``i``, in the
reference's order.  An encoder-decoder config adds
``params["encoder"]`` (``"blocks"``: one ``attn+mlp`` position stacked
over ``encoder_layers``, and its ``"final_norm"``).

Entry points, each taking the parameter tree (``init_model``'s, or
``Model.params()``) and a batch of ``tokens`` (plus ``frames`` ``(B,
encoder_seq, d)`` for an encoder-decoder config, and optionally
``patch_embeds`` ``(B, P, d)`` for a vision config):

  * ``forward_hidden`` — the forward to the final norm, each layer under
    the config's ``remat_policy`` when autograd records it;
  * ``loss_fn``        — that forward, then the chunked cross-entropy
    against the (tied) unembedding: the training loss;
  * ``prefill``        — forward that fills the caches (KV for attention,
    the SSM state and conv tail for Mamba, the RWKV state and carried
    tokens, the encoder's cross-attention keys and values), returns the
    last position's logits;
  * ``decode_step``    — one token against the caches.

Weights are cast to the compute dtype at each use, as in the reference,
with no copy where they already have it (``serve.Engine`` holds one
compute-dtype copy; the train step casts the matrices once a step).  The
final logits are float32 hidden times the float32 unembedding, as in the
reference.

``remat_policy`` (the reference's ``jax.checkpoint`` of the scan body):
``"full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``), ``"dots"`` saves the layer's matmul outputs
without batch dimensions (``aten.mm``: the projections, not the attention
einsums) and recomputes the rest, ``"none"`` keeps everything.

Each MoE layer's aux losses are summed across layers in the reference's
order; ``forward_hidden``'s aux also carries, for a model with MoE layers,
``"moe_layers"``: each MoE layer's aux in that order, whose sums the
data-parallel train step reduces across ranks.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.options import option
from repro_torch.core import spans
from repro_torch.device import as_tensor, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (
    Init,
    chunked_softmax_xent,
    layer_norm,
    rms_norm,
    sinusoidal_positions,
    softcap,
)
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = [
    "Model", "cache_specs", "decode_step", "forward_hidden", "init_cache", "init_model", "is_spec", "loss_fn",
    "param_specs", "prefill",
]

def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _parse(kind: str) -> list[str]:
    return kind.split("+")


# ---------------------------------------------------------------------------
# Norms (rms vs layer norm per config)
# ---------------------------------------------------------------------------


def _init_norm(cfg, rng: Init) -> dict:
    if cfg.norm_type == "layernorm":
        return {"g": rng.ones((cfg.d_model,)), "b": rng.zeros((cfg.d_model,))}
    return {"g": rng.zeros((cfg.d_model,))}


def _norm_specs(cfg) -> dict:
    return {"g": (None,), "b": (None,)} if cfg.norm_type == "layernorm" else {"g": (None,)}


def _apply_norm(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["g"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["g"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def init_layer(cfg: ModelConfig, kind: str, rng: Init) -> dict:
    if kind == "rwkv":
        return {"ln1": _init_norm(cfg, rng), "tm": rwkv_mod.init_rwkv_time_mix(cfg, rng),
                "ln2": _init_norm(cfg, rng), "cm": rwkv_mod.init_rwkv_channel_mix(cfg, rng)}
    parts = _parse(kind)
    params = {"ln1": _init_norm(cfg, rng)}
    if parts[0] in ("attn", "local", "global"):
        params["mixer"] = attn_mod.init_attention(cfg, rng)
    elif parts[0] == "mamba":
        params["mixer"] = mamba_mod.init_mamba(cfg, rng)
    else:
        raise ValueError(parts[0])
    if "cross" in parts:
        params["ln_x"] = _init_norm(cfg, rng)
        params["cross"] = attn_mod.init_attention(cfg, rng)
    params["ln2"] = _init_norm(cfg, rng)
    if parts[-1] == "moe":
        params["ffn"] = moe_mod.init_moe(cfg, rng)
    else:
        params["ffn"] = mlp_mod.init_mlp(cfg, rng, gated=cfg.norm_type != "layernorm")
    return params


def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    """The logical sharding of :func:`init_layer`'s tree (one layer)."""
    if kind == "rwkv":
        return {"ln1": _norm_specs(cfg), "tm": rwkv_mod.rwkv_time_mix_specs(),
                "ln2": _norm_specs(cfg), "cm": rwkv_mod.rwkv_channel_mix_specs()}
    parts = _parse(kind)
    specs = {"ln1": _norm_specs(cfg),
             "mixer": mamba_mod.mamba_specs(cfg) if parts[0] == "mamba" else attn_mod.attention_specs(cfg)}
    if "cross" in parts:
        specs["ln_x"] = _norm_specs(cfg)
        specs["cross"] = attn_mod.attention_specs(cfg)
    specs["ln2"] = _norm_specs(cfg)
    specs["ffn"] = moe_mod.moe_specs() if parts[-1] == "moe" else mlp_mod.mlp_specs(gated=cfg.norm_type != "layernorm")
    return specs


def _mixer(kind: str) -> str:
    return "local" if _parse(kind)[0] == "local" else "global"


def _ffn(cfg, kind, p, x):
    """The block's second half: ``(x + ffn(norm(x)), the MoE aux or
    None)``."""
    h = _apply_norm(cfg, p["ln2"], x)
    if _parse(kind)[-1] == "moe":
        h, aux = moe_mod.apply_moe(cfg, p["ffn"], h)
        return x + h, aux
    return x + mlp_mod.apply_mlp(cfg, p["ffn"], h, gated=cfg.norm_type != "layernorm"), None


def _cross(cfg, p, x, enc_kv=None, enc_states=None):
    """The decoder's cross-attention residual: ``x + cross(norm(x))``."""
    return x + attn_mod.apply_cross_attention(cfg, p["cross"], _apply_norm(cfg, p["ln_x"], x), enc_kv, enc_states)


def apply_layer_train(cfg, kind, p, x, positions, enc_states=None, *, causal: bool = True):
    """Pre-norm residual block (train / eval forward) → ``(x, the MoE
    layer's aux or None)``; ``causal=False`` in the encoder."""
    if kind == "rwkv":
        h, _ = rwkv_mod.apply_rwkv_time_mix(cfg, p["tm"], _apply_norm(cfg, p["ln1"], x))
        x = x + h
        h, _ = rwkv_mod.apply_rwkv_channel_mix(cfg, p["cm"], _apply_norm(cfg, p["ln2"], x))
        return x + h, None
    parts = _parse(kind)
    h = _apply_norm(cfg, p["ln1"], x)
    if parts[0] == "mamba":
        h, _ = mamba_mod.apply_mamba(cfg, p["mixer"], h)
    else:
        h = attn_mod.apply_attention(cfg, p["mixer"], h, positions, kind=_mixer(kind), causal=causal,
                                     rope=cfg.use_rope)
    x = x + h
    if "cross" in parts:
        x = _cross(cfg, p, x, enc_states=enc_states)
    return _ffn(cfg, kind, p, x)


def _unstacked(tree) -> list:
    """The trees of a stacked tree's slices ``[0], [1], ...``: views from one
    ``unbind`` a leaf (its backward stacks the slices' gradients once)."""
    if tree is None:
        return None
    parts = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [u[r] for u in parts]) for r in range(len(parts[0]))]


def _layers(cfg, params, cache=None):
    """``(kind, layer params, layer cache)`` in the reference's scan order:
    repeat ``r``, then pattern position ``i``; views of the stacked
    leaves, so a write to a layer's cache lands in ``cache``."""
    blocks = [_unstacked(b) for b in params["blocks"]]
    caches = [None] * len(cfg.pattern) if cache is None else [_unstacked(c) for c in cache]
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            yield kind, blocks[i][r], None if caches[i] is None else caches[i][r]


_ENCODER = ("attn+mlp",)  # the encoder's one pattern position


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def _stacked_blocks(cfg, rng: Init, pattern: tuple, repeats: int) -> list[dict]:
    """Per pattern position, its ``repeats`` layers stacked on a leading
    axis, drawn layer by layer (the stack holds one layer more at most)."""
    blocks = []
    for kind in pattern:
        first = init_layer(cfg, kind, rng)
        stacked = tree_map(lambda t: t.new_empty((repeats,) + t.shape), first)
        tree_map(lambda s, t: s[0].copy_(t), stacked, first)
        del first
        for r in range(1, repeats):
            tree_map(lambda s, t: s[r].copy_(t), stacked, init_layer(cfg, kind, rng))
        blocks.append(stacked)
    return blocks


def init_model(cfg: ModelConfig, generator: torch.Generator | None = None, *, device=None) -> dict:
    """The parameter tree in the reference's layout (``embed``,
    ``blocks[i][...]`` stacked over ``repeats``, ``final_norm``,
    ``unembed`` unless embeddings are tied, and ``encoder`` for an
    encoder-decoder config), float32, drawn from ``generator`` (``None`` →
    seed 0) on ``device`` (``None`` → the generator's device, or the
    card)."""
    if device is None and generator is not None:
        device = generator.device
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    rng = Init(generator, dev)
    params = {"embed": rng.normal((cfg.vocab_size, cfg.d_model), 0.02)}
    params["blocks"] = _stacked_blocks(cfg, rng, cfg.pattern, cfg.repeats)
    params["final_norm"] = _init_norm(cfg, rng)
    if not cfg.tie_embeddings:
        params["unembed"] = rng.normal((cfg.vocab_size, cfg.d_model), 0.02)
    if cfg.is_encoder_decoder:
        params["encoder"] = {"blocks": _stacked_blocks(cfg, rng, _ENCODER, cfg.encoder_layers),
                             "final_norm": _init_norm(cfg, rng)}
    return params


def is_spec(node) -> bool:
    """A leaf of a logical spec tree: a tuple of axis names or ``None``."""
    return isinstance(node, tuple) and all(e is None or isinstance(e, str) for e in node)


def _stacked_specs(tree):
    """A layer's spec tree with the leading ``"layers"`` entry of its stack."""
    if is_spec(tree):
        return ("layers",) + tree
    return {k: _stacked_specs(v) for k, v in tree.items()}


def param_specs(cfg: ModelConfig) -> dict:
    """The logical sharding of :func:`init_model`'s tree, leaf for leaf: a
    tuple of logical axis names (or ``None``) per dimension, the
    reference's ``init_model(..., abstract=True)`` specs (the stacked
    blocks lead with ``"layers"``)."""
    specs = {"embed": ("vocab", "embed"),
             "blocks": [_stacked_specs(layer_specs(cfg, kind)) for kind in cfg.pattern],
             "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["unembed"] = ("vocab", "embed")
    if cfg.is_encoder_decoder:
        specs["encoder"] = {"blocks": [_stacked_specs(layer_specs(cfg, _ENCODER[0]))],
                            "final_norm": _norm_specs(cfg)}
    return specs


class _Tree(torch.nn.Module):
    """A nested dict of tensors (lists for the blocks) as registered
    parameters and submodules; :meth:`params` gives the tree back."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, node in tree.items():
            if isinstance(node, dict):
                self.add_module(key, _Tree(node))
            elif isinstance(node, list):
                self.add_module(key, torch.nn.ModuleList(_Tree(c) for c in node))
            else:
                self.register_parameter(key, torch.nn.Parameter(node))

    def params(self) -> dict:
        out = {}
        for key in self._keys:
            node = getattr(self, key)
            if isinstance(node, torch.nn.ModuleList):
                out[key] = [c.params() for c in node]
            else:
                out[key] = node.params() if isinstance(node, _Tree) else node
        return out


class Model(_Tree):
    """The model as an ``nn.Module``: the parameters of :func:`init_model`
    (or ``params``, a tree of that layout, e.g. from
    ``convert.params_from_reference``) registered in the reference's tree
    layout.  ``flatten_with_path(model.params())`` names them as
    ``jax.tree_util`` names the reference's tree; the functional entry
    points take that tree."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(params if params is not None else init_model(cfg, generator, device=device))
        self.cfg = cfg

    def forward(self, batch: dict) -> torch.Tensor:
        """The final hidden states ``(B, S, d)``."""
        return forward_hidden(self.cfg, self.params(), batch)[0]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _tokens(params, tokens) -> torch.Tensor:
    return as_tensor(tokens, params["embed"].device).long()


def _embed_tokens(cfg, params, tokens):
    dt = _compute_dtype(cfg)
    x = params["embed"][_tokens(params, tokens)].to(dt)  # gather, then cast: the same bits
    if cfg.embed_scale:
        # √d rounded to the compute dtype first, as the reference's jnp.asarray(√d, dt)
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dt).item()
    return x


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)


def _sinusoidal(cfg) -> bool:
    """Sinusoidal positions join the stream: no RoPE, and the port option
    ``positions`` is not ``"none"``."""
    return not cfg.use_rope and option(cfg, "positions") != "none"


def _stream(cfg, params, batch: dict):
    """The decoder's input stream: the embedded tokens, after the patch
    embeddings of a vision batch, plus sinusoidal positions where
    :func:`_sinusoidal`."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = torch.cat([as_tensor(batch["patch_embeds"], x.device).to(x.dtype), x], dim=1)
    if not _sinusoidal(cfg):
        return x
    return x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)


def _run_encoder(cfg, params, frames):
    """The whisper encoder over stub frame embeddings ``(B, S_enc, d)``:
    sinusoidal positions, non-causal ``attn+mlp`` layers under the
    config's ``remat_policy``, the encoder's final norm."""
    dt = _compute_dtype(cfg)
    frames = as_tensor(frames, params["embed"].device)
    S = frames.shape[1]
    x = frames.to(dt) + sinusoidal_positions(S, cfg.d_model, frames.device).to(dt)
    positions = _positions(S, x.device)
    layer = _remat(cfg, functools.partial(apply_layer_train, cfg, _ENCODER[0], causal=False))
    for p in _unstacked(params["encoder"]["blocks"][0]):
        x, _ = layer(p, x, positions)
    return _apply_norm(cfg, params["encoder"]["final_norm"], x)


def _encoder_states(cfg, params, batch: dict):
    return _run_encoder(cfg, params, batch["frames"]) if cfg.is_encoder_decoder else None


def _save_matmuls(ctx, op, *args, **kwargs):
    """``"dots"``: keep the outputs of matmuls without batch dimensions
    (``dots_with_no_batch_dims_saveable``), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` under the config's ``remat_policy`` while autograd records."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat_policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat_policy {cfg.remat_policy!r}")


def forward_hidden(cfg, params, batch: dict):
    """Train/eval forward → ``(final hidden (B, S, d), aux dict)``: the MoE
    load-balance and router-z losses summed over the layers (0-d float32
    zeros without MoE layers), and ``"moe_layers"`` where there are some
    (module docstring)."""
    x = _stream(cfg, params, batch)
    positions = _positions(x.shape[1], x.device)
    enc_states = _encoder_states(cfg, params, batch)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"moe_load_balance": zero, "moe_router_z": zero}
    moe_layers = []
    for kind, p, _ in _layers(cfg, params):
        x, a = _remat(cfg, functools.partial(apply_layer_train, cfg, kind, enc_states=enc_states))(p, x, positions)
        if a is not None:
            aux = {k: v + a[k] for k, v in aux.items()}
            moe_layers.append(a)
    if moe_layers:
        aux["moe_layers"] = moe_layers
    return _apply_norm(cfg, params["final_norm"], x), aux


def moe_layer_count(cfg) -> int:
    """What ``loss_fn`` divides the summed MoE terms by: the MoE layers,
    at least 1."""
    return cfg.repeats * max(sum(1 for k in cfg.pattern if "moe" in k), 1)


def loss_fn(cfg, params, batch: dict):
    """Mean CE + MoE aux losses → ``(loss, {"ce", "moe_load_balance",
    "moe_router_z"})``.  ``batch``: ``tokens``, ``targets``, ``mask``
    (and the frontend's ``frames`` or ``patch_embeds``)."""
    hidden, aux = forward_hidden(cfg, params, batch)
    unemb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    dev = hidden.device
    ce = chunked_softmax_xent(
        hidden, unemb, as_tensor(batch["targets"], dev), as_tensor(batch["mask"], dev),
        s_chunk=cfg.loss_chunk, final_cap=cfg.final_softcap,
    )
    n_layers = moe_layer_count(cfg)
    lb = aux["moe_load_balance"] / n_layers
    zl = aux["moe_router_z"] / n_layers
    loss = ce + cfg.moe_aux_weight * lb + cfg.moe_z_weight * zl
    return loss, {"ce": ce, "moe_load_balance": lb, "moe_router_z": zl}


# ---------------------------------------------------------------------------
# Decode caches, prefill and decode
# ---------------------------------------------------------------------------


def _layer_cache(cfg, kind, batch: int, max_seq: int, dtype, device) -> dict:
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device)
    parts = _parse(kind)
    if parts[0] == "mamba":
        cache = {"ssm": mamba_mod.init_mamba_cache(cfg, batch, dtype, device)}
    else:
        cache = {"kv": attn_mod.init_kv_cache(cfg, batch, max_seq, dtype, device)}
    if "cross" in parts:
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        cache["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None) -> tuple:
    """Per pattern position, its caches stacked over ``repeats``, zeros on
    ``device`` (``None`` → the card): ``{"kv": {"k", "v"}}`` of
    ``(repeats, batch, max_seq, kv heads, head_dim)`` for attention,
    ``{"ssm": {"h", "conv"}}`` for Mamba, ``{"S", "x_tm", "x_cm"}`` for
    RWKV (``h`` and ``S`` float32 whatever ``dtype``), and beside the KV a
    cross layer's ``{"cross": {"k", "v"}}`` of ``(repeats, batch,
    encoder_seq, kv heads, head_dim)``."""
    dev = resolve_device(device)
    return tuple(
        tree_map(lambda t: t.expand((cfg.repeats,) + t.shape).clone(),
                 _layer_cache(cfg, kind, batch, max_seq, dtype, dev))
        for kind in cfg.pattern
    )


def _layer_cache_specs(cfg, kind: str) -> dict:
    """The logical sharding of one layer's cache (``_layer_cache``)."""
    if kind == "rwkv":
        return rwkv_mod.rwkv_cache_specs()
    parts = _parse(kind)
    specs = ({"ssm": mamba_mod.mamba_cache_specs()} if parts[0] == "mamba"
             else {"kv": attn_mod.kv_cache_specs()})
    if "cross" in parts:
        specs["cross"] = {"k": ("batch_kv", None, "kv_heads_cache", None),
                          "v": ("batch_kv", None, "kv_heads_cache", None)}
    return specs


def cache_specs(cfg: ModelConfig) -> tuple:
    """The logical sharding of :func:`init_cache`'s tree, leaf for leaf
    (the reference's ``init_cache(..., abstract=True)`` specs)."""
    return tuple(_stacked_specs(_layer_cache_specs(cfg, kind)) for kind in cfg.pattern)


def _logits(cfg, params, x):
    unemb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return softcap(x.float() @ unemb.float().T, cfg.final_softcap)


def _rwkv_layer(cfg, p, cache, x, decode: bool):
    """An RWKV layer against its cache (written in place): from zeros in
    prefill, from the carried state and tokens in decode."""
    h = _apply_norm(cfg, p["ln1"], x)
    carry = dict(state=cache["S"], x_carry=cache["x_tm"].to(h.dtype)) if decode else {}
    h, (S_f, x_tm) = rwkv_mod.apply_rwkv_time_mix(cfg, p["tm"], h, **carry)
    x = x + h
    h = _apply_norm(cfg, p["ln2"], x)
    h, x_cm = rwkv_mod.apply_rwkv_channel_mix(cfg, p["cm"], h, cache["x_cm"].to(h.dtype) if decode else None)
    cache["S"].copy_(S_f)
    cache["x_tm"].copy_(x_tm)
    cache["x_cm"].copy_(x_cm)
    return x + h


def _layer_prefill(cfg, kind, p, cache, x, positions, enc_states):
    if kind == "rwkv":
        return _rwkv_layer(cfg, p, cache, x, decode=False)
    parts = _parse(kind)
    h = _apply_norm(cfg, p["ln1"], x)
    if parts[0] == "mamba":
        with spans.span("model.mamba"):
            h, state = mamba_mod.prefill_mamba(cfg, p["mixer"], h)
        for key, t in state.items():
            cache["ssm"][key].copy_(t)
    else:
        h, _ = attn_mod.prefill_attention(cfg, p["mixer"], h, positions, cache["kv"], kind=_mixer(kind))
    x = x + h
    if "cross" in parts:  # the encoder's keys and values, once a request
        ck, cv = attn_mod.encode_cross_kv(cfg, p["cross"], enc_states)
        cache["cross"]["k"].copy_(ck)
        cache["cross"]["v"].copy_(cv)
        x = _cross(cfg, p, x, enc_kv=(ck, cv))
    return _ffn(cfg, kind, p, x)[0]


def prefill(cfg, params, batch: dict, cache: tuple):
    """Process the whole prompt (after its patch embeddings), fill the
    caches in place (KV at ``[0, S)``, the SSM state and conv tail, the
    RWKV state and last tokens, the cross-attention keys and values),
    return ``(last-position logits (B, 1, V), cache)``."""
    x = _stream(cfg, params, batch)
    positions = _positions(x.shape[1], x.device)
    enc_states = _encoder_states(cfg, params, batch)
    for kind, p, c in _layers(cfg, params, cache):
        x = _layer_prefill(cfg, kind, p, c, x, positions, enc_states)
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x), cache


def _layer_decode(cfg, kind, p, cache, x, pos: torch.Tensor):
    if kind == "rwkv":
        return _rwkv_layer(cfg, p, cache, x, decode=True)
    parts = _parse(kind)
    h = _apply_norm(cfg, p["ln1"], x)
    if parts[0] == "mamba":
        h, new = mamba_mod.decode_mamba_step(cfg, p["mixer"], h, cache["ssm"])
        for key, t in new.items():
            cache["ssm"][key].copy_(t)
    else:
        h, _ = attn_mod.decode_attention_step(cfg, p["mixer"], h, pos, cache["kv"], kind=_mixer(kind))
    x = x + h
    if "cross" in parts:
        x = _cross(cfg, p, x, enc_kv=(cache["cross"]["k"].to(h.dtype), cache["cross"]["v"].to(h.dtype)))
    return _ffn(cfg, kind, p, x)[0]


def decode_step(cfg, params, cache: tuple, token, pos):
    """token: ``(B, 1)`` ids; pos: the index of that token, an int32 tensor
    of one element (0-d or ``(1,)``) on the model's device (a host ``int``
    is filled into a 0-d one here, once), which every layer reads where it
    lies → ``(logits (B, 1, V), cache)``, the caches written in place (KV
    at ``pos``).  No step reads a host value of ``pos``, so a CUDA graph of
    one step serves every position."""
    x = _embed_tokens(cfg, params, token)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int32, device=x.device)
    if _sinusoidal(cfg):
        i = torch.arange(cfg.d_model // 2, dtype=torch.float32, device=x.device)
        # pos times the reciprocal: the bits a host pos gave, since torch divides a Python number by a
        # tensor as the tensor's reciprocal times the number
        angle = pos.float() * torch.pow(10000.0, 2 * i / cfg.d_model).reciprocal()
        x = x + torch.cat([torch.sin(angle), torch.cos(angle)]).to(x.dtype)
    for kind, p, c in _layers(cfg, params, cache):
        x = _layer_decode(cfg, kind, p, c, x, pos)
    x = _apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), cache

