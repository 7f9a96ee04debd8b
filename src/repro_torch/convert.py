"""Carry ``HistogramStore`` state across from the JAX package.

The two packages share their on-disk formats, so an npz that one saved
loads in the other (``HistogramStore.load``) and a WAL written by one
replays in the other.  :func:`store_from_reference` takes the state
in memory instead: the ``(meta, arrays)`` pair of the reference's
``HistogramStore._state()`` (or the full meta dict that its ``save``
writes, which adds the store configuration).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.retention import policy_from_spec
from repro_torch.core.stream import HistogramStore

__all__ = ["store_from_reference"]


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
