"""Carry ``HistogramStore``, ``TenantRegistry`` and optimizer state across
from the JAX package.

The two packages share their on-disk formats, so an npz that one saved
loads in the other (``HistogramStore.load``, ``TenantRegistry.load``) and
a WAL written by one replays in the other.  :func:`store_from_reference`
takes a store's state in memory instead: the ``(meta, arrays)`` pair of
the reference's ``HistogramStore._state()`` (or the full meta dict that
its ``save`` writes, which adds the store configuration).
:func:`registry_from_reference` takes a registry's: the meta dict and the
arrays of the reference's ``TenantRegistry.save`` container.
:func:`opt_state_from_reference` takes the reference's optimizer state
(``repro.optim.init_opt_state``/``adamw_update``, or the train step's
``make_opt_state``) as NumPy arrays.
:func:`params_from_reference` and :func:`cache_from_reference` take a
model's parameter tree (``repro.models.init_model``) and its decode cache
(``init_cache``, ``prefill``, ``decode_step``), leaves as NumPy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.retention import policy_from_spec
from repro_torch.core.stream import HistogramStore
from repro_torch.core.tenant import TenantRegistry
from repro_torch.device import as_tensor, resolve_device
from repro_torch.tree import tree_map

__all__ = [
    "cache_from_reference",
    "opt_state_from_reference",
    "params_from_reference",
    "registry_from_reference",
    "store_from_reference",
]


def _config(meta: dict, arrays, overrides: dict) -> dict:
    """Store configuration: explicit ``overrides``, then the save meta's
    own keys, then what the tree meta implies."""
    tree = meta.get("tree", {})
    num_buckets = overrides.get("num_buckets", meta.get("num_buckets"))
    if num_buckets is None:
        widths = [np.asarray(arrays[f"s_{pid}"]).shape[-1] for pid in meta["ids"]]
        num_buckets = int(tree.get("T_node", max(widths, default=1)))
    if "T_node" in meta:
        T_node = meta["T_node"]
    elif tree.get("geometric"):
        T_node = "geometric"
    elif tree.get("T_node", num_buckets) != num_buckets:
        T_node = int(tree["T_node"])
    else:
        T_node = None
    cfg = {
        "num_buckets": int(num_buckets),
        "T_node": T_node if T_node in (None, "geometric") else int(T_node),
        "engine": str(meta.get("engine", "tree")),
        "cache_size": int(meta.get("cache_size", 128)),
        "retention": policy_from_spec(meta.get("retention")),
        "collapse": str(meta.get("collapse", "canonical")),
    }
    cfg.update(overrides)
    return cfg


def store_from_reference(
    meta: dict, arrays: dict[str, np.ndarray], device=None, **store_kwargs
) -> HistogramStore:
    """A port store holding the reference store's summaries and pre-merged
    tree nodes, bit for bit, on ``device`` (``None`` → ``"cuda"``).

    ``meta, arrays = ref_store._state()``; ``store_kwargs`` override the
    configuration (``num_buckets`` is needed only when the tree meta
    cannot imply it: an integer ``T_node`` from a bare ``_state()``)."""
    store = HistogramStore(device=device, **_config(meta, arrays, store_kwargs))
    store._restore(meta, {k: np.asarray(v) for k, v in arrays.items()})
    return store


def registry_from_reference(
    meta: dict, arrays: dict[str, np.ndarray], device=None
) -> TenantRegistry:
    """A port registry holding every tenant of the reference registry —
    summaries, pre-merged tree nodes and the shared arena's pools, bit
    for bit — on ``device`` (``None`` → ``"cuda"``).

    ``meta`` is the json ``"meta"`` entry of the reference's
    ``TenantRegistry.save`` npz (schema ``tenant_registry/v1``) and
    ``arrays`` its other entries."""
    return TenantRegistry._from_state(
        meta, {k: np.asarray(v) for k, v in arrays.items()}, device
    )


def _leaf(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, bit for bit; bfloat16
    (``ml_dtypes``, which NumPy knows only by name) goes through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))  # a writable copy
        return bits.to(resolve_device(device)).view(torch.bfloat16)
    return as_tensor(a, device)


def opt_state_from_reference(state: dict, device=None) -> dict:
    """The port's optimizer state (``repro_torch.optim``) holding the
    reference's ``{"m", "v", "step"}`` bit for bit, on ``device``
    (``None`` → ``"cuda"``).

    ``state`` is the reference's state with its leaves as NumPy arrays
    (``jax.tree.map(np.asarray, state)``); float32 and bfloat16 moments
    keep their dtype, the step stays int32; the train step's compression
    ``"residual"`` comes across too when the state holds one."""
    out = {
        "m": tree_map(lambda a: _leaf(a, device), state["m"]),
        "v": tree_map(lambda a: _leaf(a, device), state["v"]),
        "step": _leaf(state["step"], device),
    }
    if "residual" in state:
        out["residual"] = tree_map(lambda a: _leaf(a, device), state["residual"])
    return out


def params_from_reference(params, device=None):
    """The reference's model parameter tree (``init_model(cfg, key)[0]``,
    leaves as NumPy arrays) as the port's, bit for bit and in the same
    layout, on ``device`` (``None`` → ``"cuda"``); bfloat16 goes across
    through its bits."""
    return tree_map(lambda a: _leaf(a, device), params)


def cache_from_reference(cache, device=None):
    """The reference's decode cache (the tuple of ``init_cache``,
    ``prefill`` or ``decode_step``, leaves as NumPy arrays) as the port's,
    bit for bit, on ``device`` (``None`` → ``"cuda"``)."""
    return tree_map(lambda a: _leaf(a, device), cache)
