"""Dry-run of the paper's technique itself on the production mesh.

Port of ``repro.launch.dryrun_core``.  Three ways to answer "β-bucket
equi-depth histogram of N values sharded over the mesh", priced for the
H100 in the record format of :mod:`repro_torch.launch.dryrun`:

  exact_global   — a sort of the whole sharded array, then cut (the
                   pre-paper baseline: a distributed sort ⇒ the MapReduce
                   shuffle, reborn as all-to-all traffic)
  merge          — the paper: a per-device exact T-bucket summary, an
                   all-gather of k·(2T+1) scalars, a replicated merge
                   (``core.distributed.distributed_histogram``)
  hierarchical   — tile → device → pod with composed bounds
                   (``core.distributed.distributed_histogram_hierarchical``)

The port's kernels are bound through ``ctypes``, so no pass over stand-in
tensors can run through them.  Each variant is instead the list of kernel
launches and collectives it makes on one device, each launch priced by
the byte and operation counts of :mod:`repro_torch.kernels.cost` (the
ones ``chip_smoke.py`` holds the kernels to): its bound is the larger of
its bytes over ``HBM_BW`` and its operations over ``F32_FLOPS``, and a
variant's memory and compute terms are the sums over its launches.  The
all-gathers carry ``gather_and_merge``'s shapes: T + 1 float32
boundaries and T float32 sizes a summary, gathered over one mesh axis
after another.  ``exact_global`` is priced as a sample sort: an
all-to-all of the shard (its 4-byte values), a row sort of what arrives,
and an all-gather of each device's count to place the β + 1 cuts.

Writes ``results/dryrun_torch/core__<variant>__<mesh>.json``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun_core [--n N] [--t T] [--beta B] [--mesh both]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.kernels.cost import CARD, F32_FLOPS, HBM_BW, bound_s, merge_cost, row_sort_cost
from repro_torch.launch.dryrun import StandInMesh, axis_bandwidth, collective_record, production_mesh

__all__ = ["VARIANTS", "plan", "run"]

VARIANTS = ("exact_global", "merge", "hierarchical")


def _gathers(mesh: StandInMesh, axes, T: int) -> tuple[list, int]:
    """``gather_and_merge``'s all-gathers of one T-bucket summary over
    ``axes`` in order: ``(axis, output bytes)`` each, and the summaries
    the merge then sees."""
    out, k = [], 1
    for ax in axes:
        k *= mesh.sizes[ax]
        out.append((ax, 4.0 * k * (2 * T + 1)))
    return out, k


TILE_SIZE, T_TILE = 8192, 2048  # the hierarchical variant's tiles, as the reference runs it


def plan(variant: str, mesh: StandInMesh, N: int, T: int, beta: int) -> dict:
    """One device's kernel launches (``name``, ``shape``, ``bytes``,
    ``ops``) and collectives (``kind``, ``axis``, ``bytes``) for
    ``variant`` over N values sharded evenly across ``mesh``."""
    axes = tuple(mesh.mesh_dim_names)
    n = N // mesh.size
    launches, colls = [], []

    def launch(name, shape, cost):
        launches.append({"name": name, "shape": shape, "bytes": cost[0], "ops": cost[1]})

    if variant == "exact_global":
        for ax in axes:  # the shuffle: every value moves to the device that owns its range
            colls.append({"kind": "all-to-all", "axis": ax, "bytes": 4.0 * n})
        launch("tile_sort", f"1 x {n} -> {beta} cuts", row_sort_cost(1, n, beta))
        for ax in axes:
            colls.append({"kind": "all-gather", "axis": ax, "bytes": 8.0 * mesh.sizes[ax]})
    elif variant == "merge":
        launch("tile_sort", f"1 x {n} -> {T} buckets", row_sort_cost(1, n, T))
        gathers, k = _gathers(mesh, axes, T)
        colls += [{"kind": "all-gather", "axis": ax, "bytes": b} for ax, b in gathers]
        launch("merge_cut", f"Q=1 k={k} T+1={T + 1} beta={beta}", merge_cost(1, k, T + 1, beta))
    elif variant == "hierarchical":
        tiles = n // TILE_SIZE
        launch("tile_sort", f"{tiles} x {TILE_SIZE} -> {T_TILE} buckets", row_sort_cost(tiles, TILE_SIZE, T_TILE))
        launch("merge_cut", f"Q=1 k={tiles} T+1={T_TILE + 1} beta={T}", merge_cost(1, tiles, T_TILE + 1, T))
        data_axes = tuple(a for a in axes if a != "pod")
        gathers, k = _gathers(mesh, data_axes, T)
        colls += [{"kind": "all-gather", "axis": ax, "bytes": b} for ax, b in gathers]
        if "pod" in axes:
            launch("merge_cut", f"Q=1 k={k} T+1={T + 1} beta={T}", merge_cost(1, k, T + 1, T))
            gathers, k = _gathers(mesh, ("pod",), T)
            colls += [{"kind": "all-gather", "axis": ax, "bytes": b} for ax, b in gathers]
        launch("merge_cut", f"Q=1 k={k} T+1={T + 1} beta={beta}", merge_cost(1, k, T + 1, beta))
    else:
        raise ValueError(variant)
    for item in launches:
        item["bound_s"], item["bound_by"] = bound_s(item["bytes"], item["ops"])
    return {"n_per_device": n, "launches": launches, "collectives": colls}


def run(variant: str, multi_pod: bool, N: int, T: int, beta: int, *, mesh: StandInMesh | None = None) -> dict:
    """The dry-run record of one variant (``dryrun``'s keys)."""
    mesh = mesh or production_mesh(multi_pod)
    p = plan(variant, mesh, N, T, beta)
    coll, coll_s = {}, 0.0
    for c in p["collectives"]:
        if mesh.sizes[c["axis"]] > 1:
            key = (c["kind"], c["axis"])
            coll[key] = coll.get(key, 0.0) + c["bytes"]
            coll_s += c["bytes"] / axis_bandwidth(mesh, c["axis"])
    ops = sum(item["ops"] for item in p["launches"])
    nbytes = sum(item["bytes"] for item in p["launches"])
    terms = {"compute_s": ops / F32_FLOPS, "memory_s": nbytes / HBM_BW, "collective_s": coll_s}
    # the shard, and the largest launch's inputs and outputs beside it
    peak = 4 * p["n_per_device"] + max(item["bytes"] for item in p["launches"])
    return {
        "arch": f"core-{variant}", "shape": f"N{N >> 20}M_T{T}_b{beta}", "mesh": mesh.name, "kind": "core",
        "status": "ok", "card": CARD,
        "cost_source": "kernel launches priced by repro_torch.kernels.cost; collectives by "
                       "gather_and_merge's shapes (module docstring)",
        "launches": p["launches"],
        "hlo_flops_per_device": ops,
        "hlo_bytes_per_device": nbytes,
        "collectives": collective_record(coll),
        "terms": terms,
        "dominant": max(terms, key=terms.get),
        "roofline_step_s": max(terms.values()),
        "kernel_bound_s": sum(item["bound_s"] for item in p["launches"]),
        "memory": {"peak_bytes_per_device": int(peak)},
        "useful_compute_ratio": float("nan"),
        "model_flops_per_device": 0.0,
        "mfu_upper_bound": 0.0,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 30)  # 1 Gi values
    ap.add_argument("--t", type=int, default=40 * 254)  # paper's T ≥ 40β
    ap.add_argument("--beta", type=int, default=254)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for variant in VARIANTS:
        for mp in meshes:
            rec = run(variant, mp, args.n, args.t, args.beta)
            path = os.path.join(args.out, f"core__{variant}__{rec['mesh']}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            t = rec["terms"]
            print(f"{variant:14s} {rec['mesh']}: ops/dev={rec['hlo_flops_per_device']:.3e} "
                  f"c/m/x={t['compute_s']:.6f}/{t['memory_s']:.6f}/{t['collective_s']:.6f}s "
                  f"dominant={rec['dominant']} kernel bound={rec['kernel_bound_s'] * 1e3:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
