"""Distributed summarize-and-merge — the paper's framework on a device mesh.

PyTorch port of ``repro.core.distributed``.  The Hadoop mapping:

    Summarizer job   →  per-rank exact histogram of the local shard
                        (``build_exact``; the row-sort kernel on the card)
    summary files    →  ``(T+1)`` boundaries + ``T`` sizes per rank
    Merger job       →  ``all_gather`` of the summaries (tiny) + one
                        ``merge`` computed replicated on every rank (the
                        merge kernel on the card)

SPMD the torch way.  Where the reference takes one global array sharded
over the mesh and runs inside ``shard_map``, every rank of a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`) calls these functions with its own
shard: the one ``P(axis_names)`` gives its mesh coordinate, which is the
mesh's row-major rank order.  The all-gathers run over
``mesh.get_group(axis)`` — NCCL on the card, gloo in the CPU tests — and
stack the ranks of each axis in front, so the merge sees its input rows
in the reference's order (which matters wherever boundaries tie).  A call
with a mesh runs the collective or raises; nothing falls back to a local
answer.

Hierarchical merge: exact sorts only ever touch tile-sized blocks; the
paper's own theorem is applied recursively tile → device → pod with
composed bound ``ε_total < 2N · Σ_level 1/T_level``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.histogram import (
    Histogram,
    as_tensor,
    build_exact,
    build_exact_batched,
    merge,
)
from repro_torch.device import home

__all__ = [
    "local_summarize",
    "gather_and_merge",
    "distributed_histogram",
    "hierarchical_device_summary",
    "hierarchical_eps_bound",
    "distributed_histogram_hierarchical",
    "tensor_histogram_in_step",
]


def hierarchical_eps_bound(
    n: int,
    T_levels: Sequence[int],
    merges_k: Sequence[int] = (),
) -> float:
    """Composed Theorem-1 bound for a multi-level merge hierarchy.

    ``ε_total < 2N · Σ_level 1/T_level`` plus ``2k`` integer slack per merge
    of ``k`` inputs — the recursion used tile → device → pod here and across
    time by the segment-tree interval engine (``core/interval_tree.py``).
    """
    eps = 2.0 * n * sum(1.0 / T for T in T_levels)
    return eps + 2.0 * sum(merges_k)


def _axes(axis_names: str | Sequence[str]) -> tuple[str, ...]:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def _axis_size(mesh, ax: str) -> int:
    names = mesh.mesh_dim_names or ()
    if ax not in names:
        raise KeyError(f"mesh axes are {names}, not {ax!r}")
    return mesh.size(names.index(ax))


def _all_gather(t: torch.Tensor, mesh, ax: str) -> torch.Tensor:
    """Every rank's ``t`` along mesh axis ``ax``, stacked in front in the
    axis's rank order (``jax.lax.all_gather``)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh collective needs an initialized process group")
    group = mesh.get_group(ax)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def local_summarize(x_local, T: int, *, device=None) -> Histogram:
    """Summarizer: exact T-bucket histogram of this rank's shard."""
    return build_exact(as_tensor(x_local, device).reshape(-1), T)


def gather_and_merge(
    local: Histogram, beta: int, mesh, axis_names: str | Sequence[str]
) -> Histogram:
    """Merger: all-gather per-rank summaries along mesh axes and merge.

    Every rank of ``mesh`` calls it with its own summary; the axes are
    gathered in the order given, each adding a leading axis, as the
    reference's ``jax.lax.all_gather`` does inside ``shard_map``.  Moves
    ``k·(2T+1)`` scalars instead of ``N`` raw values — the paper's
    shuffle-avoidance, realized on the interconnect.
    """
    device = home(*local)
    b = as_tensor(local.boundaries, device)
    s = as_tensor(local.sizes, b.device)
    for ax in _axes(axis_names):
        b = _all_gather(b, mesh, ax)
        s = _all_gather(s, mesh, ax)
    b = b.reshape(-1, local.boundaries.shape[-1])
    s = s.reshape(-1, local.sizes.shape[-1])
    return merge(Histogram(b, s), beta)


def hierarchical_device_summary(
    x_local, tile_size: int, T_tile: int, T_device: int, *, device=None
) -> Histogram:
    """Tile-level summarize + merge on one device (level 0 of the hierarchy).

    The shard is cut into tiles; each tile is summarized exactly (one
    row-sort launch over all of them on the card) and the per-tile
    summaries are merged into the device summary.  The tail that does not
    fill a tile forms one final smaller exact histogram.
    """
    flat = as_tensor(x_local, device).reshape(-1)
    n = flat.shape[0]
    n_tiles = n // tile_size
    if n_tiles == 0:
        return build_exact(flat, T_device)
    head = flat[: n_tiles * tile_size].reshape(n_tiles, tile_size)
    tiles = build_exact_batched(head, T_tile)
    rem = n - n_tiles * tile_size
    if rem > 0:
        tail = build_exact(flat[n_tiles * tile_size :], min(T_tile, rem))
        pad = T_tile - tail.sizes.shape[-1]
        tb = torch.cat([tail.boundaries, tail.boundaries[-1:].repeat(pad)])
        ts = torch.cat([tail.sizes, tail.sizes.new_zeros((pad,))])
        tiles = Histogram(
            torch.cat([tiles.boundaries, tb[None]], dim=0),
            torch.cat([tiles.sizes, ts[None]], dim=0),
        )
    return merge(tiles, T_device)


def distributed_histogram(
    x,
    T: int,
    beta: int,
    mesh,
    axis_names: str | Sequence[str] = "data",
    *,
    device=None,
) -> Histogram:
    """β-bucket histogram of the array sharded over ``axis_names``.

    ``x``: this rank's shard, any rank (the reference takes the global
    array whose leading dim is sharded over ``axis_names``).  Returns the
    same :class:`Histogram` on every rank.
    """
    local = local_summarize(x, T, device=device)
    return gather_and_merge(local, beta, mesh, _axes(axis_names))


def distributed_histogram_hierarchical(
    x,
    mesh,
    *,
    tile_size: int = 8192,
    T_tile: int = 512,
    T_device: int = 4096,
    T_pod: int = 4096,
    beta: int = 254,
    data_axes: tuple[str, ...] = ("data",),
    pod_axis: str | None = "pod",
    device=None,
) -> Histogram:
    """Three-level tile → device → pod merge of this rank's shard ``x``.

    Composed error bound: ``ε < 2N(1/T_tile + 1/T_device [+ 1/T_pod])``.
    When ``pod_axis`` is absent from the mesh the last level collapses.
    """
    dev = hierarchical_device_summary(x, tile_size, T_tile, T_device, device=device)
    if pod_axis and pod_axis in (mesh.mesh_dim_names or ()):
        mid = gather_and_merge(dev, T_pod, mesh, tuple(data_axes))
        return gather_and_merge(mid, beta, mesh, (pod_axis,))
    return gather_and_merge(dev, beta, mesh, tuple(data_axes))


def tensor_histogram_in_step(
    x,
    T: int,
    beta: int,
    mesh,
    axis_names: Sequence[str],
    *,
    device=None,
) -> Histogram:
    """Histogram of a tensor that every rank holds whole (a gradient after
    its all-reduce), laid out across the mesh as the reference lays it.

    Flattens, truncates the tail so the length divides the mesh size (< one
    element per rank dropped — negligible for telemetry and documented),
    summarizes this rank's ``1/k`` slice (indexed by its linear coordinate
    over ``axis_names``, the first axis major) and runs the paper's merge.
    A tensor shorter than the mesh is summarized whole on every rank,
    without a collective.  The all-gather is ``O(k·T)`` bytes, so per-step
    telemetry of every layer's gradients is affordable.
    """
    axes = _axes(axis_names)
    sizes = [_axis_size(mesh, ax) for ax in axes]
    k = math.prod(sizes)
    flat = as_tensor(x, device).reshape(-1)
    n = flat.shape[0]
    usable = (n // k) * k
    if usable < k:  # tiny tensor: replicate instead of sharding
        return build_exact(flat.to(torch.float32), min(T, max(n, 1)))
    r = 0
    for ax, size in zip(axes, sizes):
        r = r * size + mesh.get_local_rank(ax)
    per = usable // k
    local = local_summarize(flat[r * per : (r + 1) * per].to(torch.float32), min(T, per))
    return gather_and_merge(local, beta, mesh, axes)
