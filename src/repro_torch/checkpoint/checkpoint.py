"""Checkpointing with atomic manifests and elastic restore.

Port of ``repro.checkpoint.checkpoint`` with the same on-disk format, so a
checkpoint that one package writes restores in the other:

  <dir>/step_<N>/
     manifest.json   — step, the sorted array keys, ``extra``
     arrays.npz      — ``p|<keystr>`` per parameter leaf, ``o|<keystr>`` per
                       optimizer-state leaf; leaves named by
                       :func:`repro_torch.tree.flatten_with_path` (as
                       ``jax.tree_util.keystr`` names them); bfloat16 stored
                       as float32 (a lossless container) and cast back to
                       the template's dtype on restore
  <dir>/LATEST       — atomic pointer file (written via rename)

Durability is the reference's: the payload and the manifest are fsynced
before the step directory's rename, the directory after it, and the
``LATEST`` pointer is fsynced before its own rename.  The failpoints
``checkpoint.save`` and ``checkpoint.restore`` fire first in each call.

Restore is *elastic*: arrays are loaded on the host and placed on the
template leaves' devices (or ``device=``), or — given a tree of
``(DeviceMesh, placements)`` — distributed over the *current* mesh as
DTensors (``torch.distributed.tensor.distribute_tensor``), whatever mesh
saved them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.core import failpoints as faults
from repro_torch.device import resolve_device
from repro_torch.tree import flatten_with_path, unflatten

__all__ = ["gc_checkpoints", "latest_step", "restore_checkpoint", "save_checkpoint"]

SEP = "|"


def _fsync_dir(path: str) -> None:
    """fsync a directory fd so a just-renamed entry survives a crash."""
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; a DTensor gathered whole first."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # npz can't serialize bfloat16;
            leaf = leaf.to(torch.float32)  # f32 is a lossless container and
        return leaf.cpu().numpy()  # restore re-casts via template
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in flatten_with_path(tree)}


def save_checkpoint(
    ckpt_dir: str, step: int, params: Any, opt_state: Any | None = None,
    extra: dict | None = None,
) -> str:
    """Atomic save: write to tmp dir, fsync, rename, repoint LATEST."""
    faults.hit("checkpoint.save", step=step)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        payload = {f"p{SEP}{k}": v for k, v in _flatten(params).items()}
        if opt_state is not None:
            payload.update({f"o{SEP}{k}": v for k, v in _flatten(opt_state).items()})
        arrays_path = os.path.join(tmp, "arrays.npz")
        np.savez(arrays_path, **payload)
        # np.savez closes the zip without fsync: payload fsync before the
        # rename below, directory fsync after it
        fd = os.open(arrays_path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        manifest = {"step": int(step), "keys": sorted(payload), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(ckpt_dir)  # make the rename itself durable
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer — fsynced before the rename (an un-synced
    # pointer can survive a crash as an empty file), directory fsync after
    fd, ptr_tmp = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _fsync_dir(ckpt_dir)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[-1])


def _is_placement(node) -> bool:
    """A ``(DeviceMesh, placements)`` pair: a leaf of a shardings tree."""
    return isinstance(node, tuple) and len(node) == 2 and hasattr(node[0], "mesh_dim_names")


def _placements(tree, keys: list[str]) -> list:
    """The ``(mesh, placements)`` pair of each template leaf (by its
    keystr), or ``None`` for each without a shardings tree."""
    if tree is None:
        return [None] * len(keys)
    by_key = dict(flatten_with_path(tree, is_leaf=_is_placement))
    if sorted(by_key) != sorted(keys):
        raise ValueError(f"the shardings tree's leaves {sorted(by_key)} are not the template's {sorted(keys)}")
    return [by_key[k] for k in keys]


def _place(arr: np.ndarray, leaf, device, sharding) -> torch.Tensor:
    """A host array as the template leaf's dtype, on its device (or
    ``device``), or distributed by ``sharding``."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if isinstance(leaf, torch.Tensor):
        t = t.to(leaf.dtype)
        dev = leaf.device if device is None else device
    else:
        dev = device
    if sharding is not None:
        from torch.distributed.tensor import distribute_tensor

        mesh, placements = sharding
        return distribute_tensor(t.to(mesh.device_type), mesh, list(placements))
    return t.to(resolve_device(dev))


def restore_checkpoint(
    ckpt_dir: str,
    step: int | None,
    params_template: Any,
    opt_template: Any | None = None,
    shardings: Any | None = None,
    opt_shardings: Any | None = None,
    *,
    device=None,
) -> tuple[Any, Any | None, int]:
    """Restore onto the *current* placement (templates give tree structure
    and dtypes).

    Leaves go to the template leaves' devices, or to ``device`` when it is
    given (a template leaf that is not a tensor goes to ``device``, ``None``
    → the card).  ``shardings`` trees (same structure, leaves
    ``(DeviceMesh, placements)``) return DTensors instead — restoring onto
    a different mesh than the one that saved is supported (elastic
    restart).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    faults.hit("checkpoint.restore", step=step)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    # NpzFile holds the archive fd until closed
    with np.load(os.path.join(path, "arrays.npz")) as data:

        def rebuild(template, prefix, shard_tree):
            flat = flatten_with_path(template)
            placed = _placements(shard_tree, [key for key, _ in flat])
            return unflatten(template, [
                _place(data[f"{prefix}{SEP}{key}"], leaf, device, sh)
                for (key, leaf), sh in zip(flat, placed)
            ])

        params = rebuild(params_template, "p", shardings)
        opt = rebuild(opt_template, "o", opt_shardings) if opt_template is not None else None
    return params, opt, step


def gc_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` checkpoints (never LATEST's)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[-1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
    )
    keep_set = set(steps[-keep:])
    latest = latest_step(ckpt_dir)
    if latest is not None:
        keep_set.add(latest)
    for s in steps:
        if s not in keep_set:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
