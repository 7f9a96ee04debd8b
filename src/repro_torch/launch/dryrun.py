"""Multi-node dry-run of every (arch × shape × mesh) cell, priced for the H100.

Port of ``repro.launch.dryrun``.  For each cell it gives, without
allocating a byte on any device and without a process group:

* the placement's coherence: ``Rules`` maps every parameter, optimizer,
  batch and cache leaf of the port onto a stand-in mesh (``StandInMesh``,
  the ``mesh_dim_names`` and ``shape`` that ``Rules`` reads) of 16 × 16 or
  2 × 16 × 16 ranks, and its divisibility fallbacks (``degradations``);
* the memory a device holds (``memory``): the arguments exactly, the
  outputs, and the temporaries of one step;
* the FLOPs and bytes a device moves, and the collectives the placement
  implies, in the reference's record keys;
* the three roofline terms against the H100 figures of
  :mod:`repro_torch.kernels.cost`, the dominant
  one, and ``MODEL_FLOPS`` = 6·N(_active)·D with the useful-compute ratio.

There is no XLA here, so each number has another source (``cost_source``
in the record says which):

* **Arguments** (parameters in float32, moments in
  ``cfg.optimizer_dtype`` and the int32 step for train, the batch, the
  caches): each leaf's shape with each dimension divided, rounding up, by
  the mesh size of the axes that ``Rules`` maps it to — exact integer
  arithmetic, the shard that ``Rules.placements`` places.
* **FLOPs and bytes**: one pass of the port's own ``train_step`` /
  ``prefill`` / ``decode_step`` over ``meta`` tensors (shapes and dtypes,
  no data; much faster than ``FakeTensorMode`` on RWKV's step loop),
  under a ``TorchDispatchMode`` (``_Counter``) that sees every aten op,
  the backward's and the recomputed layers' included.  FLOPs are
  ``torch.utils.flop_counter``'s formulas (the ones ``FlopCounterMode``
  applies: matmuls and convolutions), split by the dtype they run in;
  bytes are every op's operand plus output bytes, as eager PyTorch runs
  it: no fusion, views free (the analog of XLA's "bytes accessed").  The
  pass runs the config at depth 1 and at depth 2 (``costing_config``'s
  depths, production chunking: a Python loop is counted in full, so the
  chunk collapse that XLA's while loops need changes nothing here) and
  the counts are extrapolated linearly to the real depth, as the
  reference does.
* **Work per device**: every tensor carries the mesh axes it is split
  over.  A parameter carries those of its dimensions (its ``embed``
  dimension's FSDP axis apart: a weight is all-gathered before it is
  used); the batch carries ``act_batch``'s axes; a cache its spec's.  An
  op's FLOPs and bytes are divided by the product of the sizes of the
  axes its inputs carry (each axis once), and its output carries them:
  work on a dimension that the placement splits is divided by that
  split, work on a degraded (replicated) dimension is not.  Sequence
  parallelism (``act_seq`` on "model") is an axis of its own kind: the
  residual stream between blocks carries it; a matmul with a weight that
  is not split on its contracted dimension (column-parallel or
  replicated) all-gathers its activation first, and so does a matmul of
  two activations whose other operand is not sequence-split; a matmul
  with a weight split on its contracted dimension (row-parallel: ``wo``,
  ``w_down``, the vocabulary of a lookup) reduce-scatters its output back
  onto the sequence (an all-reduce where ``act_seq`` is not split:
  decode).  An elementwise op on a sequence-split input stays on the
  residual stream (its output is sequence-split only).
* **Temporaries**: the largest sum of the live storages the pass made
  (a storage lives while any tensor of it does, a view included),
  each divided as its axes divide it (activations by ``act_batch`` and
  ``act_seq``, weight copies by their placement), extrapolated from depth
  1 and 2 like the counts, less the outputs the step creates.  The pass
  sees each op's inputs and outputs, not the scratch a kernel allocates
  inside it.
* **Collectives** (per device, output bytes, as the reference's
  ``parse_collective_bytes`` sums them; one per mesh axis):
  - FSDP: an all-gather over ``embed``'s axis of every weight split
    there, in the compute dtype for a matrix (cast first): once in
    prefill and decode; in train in the forward, the recompute (remat
    other than ``"none"``) and the backward;
  - train: a reduce-scatter of each such weight's float32 gradient over
    that axis, and an all-reduce of every float32 gradient (the shard)
    over the other ``act_batch`` axes: the data-parallel reduction the
    port's step runs on a real mesh (skipped in this pass, which has no
    process group);
  - sequence parallelism: the all-gathers and reduce-scatters (decode:
    all-reduces) of the rules above, counted as the pass meets them, once
    for each tensor gathered;
  - MoE with ``experts`` over "model": an all-to-all of the experts'
    dispatched inputs and one of their outputs a layer (forward,
    recompute and backward in train);
  - decode with ``kv_seq`` split: a combine of each attention layer's
    partial float32 output and its two softmax statistics over the
    ``kv_seq`` axes (an all-reduce).
  The collective term prices each axis at its own rate
  (``axis_bandwidth``).

``parse_collective_bytes`` and ``_shape_bytes`` of the reference parse
XLA's HLO text and have no counterpart: there is no HLO.

Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(incremental: existing cells are skipped unless ``--force``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable
from repro_torch.kernels.cost import (
    CARD,
    F32_FLOPS,
    HBM_BW,
    HBM_BYTES,
    NETWORK_BW,
    NODE_GPUS,
    NVLINK_BW,
    PEAK_FLOPS,
)
from repro_torch.launch.specs import (
    Spec,
    batch_logical_specs,
    decode_input_specs,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.models.model import (
    cache_specs,
    decode_step,
    init_cache,
    init_model,
    is_spec,
    param_specs,
    prefill,
)
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import Rules
from repro_torch.train.train_step import make_opt_state, make_train_step
from repro_torch.tree import flatten_with_path, tree_map, unflatten

__all__ = [
    "COLLECTIVES", "StandInMesh", "arguments", "axis_bandwidth", "build_cell", "collective_record",
    "costing_config", "measure", "production_mesh", "run_cell",
]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_RATES = {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS}  # anything else: F32_FLOPS


@dataclasses.dataclass(frozen=True)
class StandInMesh:
    """What ``Rules`` reads of a ``DeviceMesh``: axis names and sizes."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh_dim_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def production_mesh(multi_pod: bool = False) -> StandInMesh:
    """16 × 16 ("data", "model") or 2 × 16 × 16 ("pod", "data", "model")."""
    if multi_pod:
        return StandInMesh(("pod", "data", "model"), (2, 16, 16))
    return StandInMesh(("data", "model"), (16, 16))


def axis_bandwidth(mesh: StandInMesh, axis: str) -> float:
    """The collective rate of one mesh axis, bytes/s a GPU: NVLink's where
    the axis's group lies in one node of 8 (ranks row-major over the mesh,
    nodes of 8 consecutive ranks), the network's where it spans nodes."""
    i = mesh.mesh_dim_names.index(axis)
    stride = math.prod(mesh.shape[i + 1:])
    return NVLINK_BW if stride * mesh.shape[i] <= NODE_GPUS else NETWORK_BW


def _model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode: per emitted token."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens  # forward only
    tokens = shape.global_batch  # one token per request
    return 2.0 * n_active * tokens


def costing_config(cfg, shape, r: int):
    """The reference's costing variant: depth ``r`` (layers unrolled,
    encoder scaled with it) and every chunk loop collapsed to one chunk.
    The port's passes take its depth and keep the production chunking
    (``_pass_config``): Python loops are counted in full."""
    seq = shape.seq_len
    repl = dict(
        repeats=r,
        scan_unroll=max(r, 1),
        attn_q_chunk=seq,
        loss_chunk=seq,
        mamba_chunk=seq,
        rwkv_chunk=seq,
    )
    if cfg.encoder_layers:
        repl["encoder_layers"] = r
    return dataclasses.replace(cfg, **repl)


_CHUNKS = ("attn_q_chunk", "loss_chunk", "mamba_chunk", "rwkv_chunk")


def _pass_config(cfg, shape, r: int):
    return dataclasses.replace(costing_config(cfg, shape, r), **{k: getattr(cfg, k) for k in _CHUNKS})


# ---------------------------------------------------------------------------
# Placement arithmetic
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _local_bytes(spec: Spec, logical: tuple, rules: Rules, sizes: dict) -> int:
    """Bytes of one device's shard of a leaf (each dimension divided,
    rounding up, by the mesh size of its axes)."""
    n = spec.dtype.itemsize
    for dim, entry in zip(spec.shape, rules(logical) if logical else ()):
        n *= -(-dim // math.prod(sizes[a] for a in _axes_of(entry)))
    for dim in spec.shape[len(logical):]:
        n *= dim
    return n


def _abstract_params(cfg):
    """The port's parameter tree as ``Spec`` leaves (a ``FakeTensorMode``
    ``init_model``: nothing allocated)."""
    with FakeTensorMode():
        params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return tree_map(lambda t: Spec(tuple(t.shape), t.dtype), params)


def _abstract_cache(cfg, shape):
    with FakeTensorMode():
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
    return tree_map(lambda t: Spec(tuple(t.shape), t.dtype), cache)


def _moment_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.optimizer_dtype == "bfloat16" else torch.float32


def build_cell(cfg, shape) -> dict:
    """The cell's arguments as named groups of ``(spec tree, logical spec
    tree)``: train ``params``, ``opt`` (m, v in ``cfg.optimizer_dtype``,
    the int32 step) and ``batch``; prefill ``params``, ``batch``,
    ``cache``; decode ``params``, ``cache``, ``token``, ``pos``."""
    params = _abstract_params(cfg)
    pspecs = param_specs(cfg)
    if shape.kind == "train":
        batch = train_input_specs(cfg, shape)
        mdt = _moment_dtype(cfg)
        moments = tree_map(lambda s: Spec(s.shape, mdt), params)
        opt = {"m": moments, "v": moments, "step": Spec((), torch.int32)}
        return {"params": (params, pspecs),
                "opt": (opt, {"m": pspecs, "v": pspecs, "step": ()}),
                "batch": (batch, {k: batch_logical_specs(cfg)[k] for k in batch})}
    cache = (_abstract_cache(cfg, shape), cache_specs(cfg))
    if shape.kind == "prefill":
        batch = prefill_input_specs(cfg, shape)
        return {"params": (params, pspecs), "batch": (batch, {k: batch_logical_specs(cfg)[k] for k in batch}),
                "cache": cache}
    dec = decode_input_specs(cfg, shape)
    return {"params": (params, pspecs), "cache": cache,
            "token": (dec["token"], ("act_batch", None)), "pos": (dec["pos"], ())}


def _pairs(group) -> list[tuple[str, Spec, tuple]]:
    tree, logical = group
    specs = dict(flatten_with_path(logical, is_leaf=is_spec))
    return [(k, s, specs[k]) for k, s in flatten_with_path(tree)]


def arguments(cell: dict, rules: Rules, mesh) -> dict[str, int]:
    """Per-device bytes of each argument group of :func:`build_cell`."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return {name: sum(_local_bytes(s, lg, rules, sizes) for _, s, lg in _pairs(group))
            for name, group in cell.items()}


# ---------------------------------------------------------------------------
# The counting pass
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# (first operand, second operand, contracted dim of each)
_CONTRACTIONS = {_aten.mm: (0, 1, 1, 0), _aten.addmm: (1, 2, 1, 0), _aten.bmm: (0, 1, 2, 1),
                 _aten.baddbmm: (1, 2, 2, 1)}
_SP = "sp"  # sequence parallelism: the "model" axis, on the sequence
_NOCOPY = {_aten._unsafe_view, _aten._reshape_alias, _aten.lift_fresh}  # no data moved, not marked as views
_EMPTY = frozenset()


def _tag(t):
    """``(axes, wdims)``: the axes a tensor is split over; for a weight also
    its per-dimension axes without the FSDP axis, else ``None``."""
    return getattr(t, "_dr", (_EMPTY, None))


def _map_dims(wdims, src: tuple, dst: tuple):
    """A weight's per-dimension axes carried through a reshape from shape
    ``src`` to ``dst``: dimensions grouped by equal running products, a
    group's axes landing on its first output dimension longer than 1."""
    out = [set() for _ in dst]
    i = j = 0
    while i < len(src) and j < len(dst):
        grp, pi, pj, first = set(wdims[i]), src[i], dst[j], j
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj and i < len(src):
                pi, grp, i = pi * src[i], grp | wdims[i], i + 1
            elif pj < pi and j < len(dst):
                pj, j = pj * dst[j], j + 1
            else:
                break
        out[next((d for d in range(first, j) if dst[d] != 1), first)] |= grp
    return tuple(frozenset(x) for x in out)


def _weight_out(func, packet, t, o, args):
    """The per-dimension axes of ``o``, an op's output of the weight ``t``
    alone (a cast, a view, a transpose, a slice of the stack)."""
    wd = _tag(t)[1]
    if packet in (_aten.t, _aten.transpose, _aten.permute):
        if packet is _aten.permute:
            perm = args[1]
        elif packet is _aten.transpose:
            a, b = args[1] % t.dim(), args[2] % t.dim()
            perm = list(range(t.dim()))
            perm[a], perm[b] = perm[b], perm[a]
        else:
            perm = list(range(t.dim()))[::-1]
        return tuple(wd[p] for p in perm)
    if packet in (_aten.select, _aten.unbind):
        d = args[1] % t.dim() if len(args) > 1 else 0
        return wd[:d] + wd[d + 1:]
    if packet is _aten.expand and o.dim() > t.dim():
        return (_EMPTY,) * (o.dim() - t.dim()) + wd
    if o.dim() == t.dim():  # a cast, a copy, a slice
        return wd
    return _map_dims(wd, tuple(t.shape), tuple(o.shape))


class _Counter(TorchDispatchMode):
    """Counts FLOPs (by dtype), bytes, collectives and live bytes per device
    for each mesh in ``meshes`` (module docstring), following the axes each
    tensor is split over.  ``seq_parallel``: ``act_seq`` is on "model"."""

    def __init__(self, meshes: list[StandInMesh], seq_parallel: bool):
        super().__init__()
        self.sizes = [dict(m.sizes, **{_SP: m.sizes.get("model", 1)}) for m in meshes]
        self.sp = seq_parallel
        n = len(meshes)
        self.flops = [dict() for _ in range(n)]
        self.bytes = [0.0] * n
        self.coll = [dict() for _ in range(n)]
        self.live = [0.0] * n
        self.peak = [0.0] * n
        self.ops = 0
        # storage → [tensors holding it, its bytes per device, gathered]: a
        # storage stays live while any tensor of it does (a view keeps it)
        self._storages: dict[int, list] = {}
        self._gathered_args: set[int] = set()

    def _divisors(self, axes) -> list[int]:
        axes = {"model" if a == _SP else a for a in axes}
        return [math.prod(s.get(a, 1) for a in axes) for s in self.sizes]

    def _collective(self, kind: str, axis: str, nbytes: float, axes) -> None:
        for c, s, d in zip(self.coll, self.sizes, self._divisors(axes)):
            if s.get(axis, 1) > 1:
                key = (kind, axis)
                c[key] = c.get(key, 0.0) + nbytes / d

    def _gather(self, t, axes) -> None:
        """The sequence-parallel all-gather of activation ``t`` (once per
        storage)."""
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:  # an argument, alive for the whole pass
            if key in self._gathered_args:
                return
            self._gathered_args.add(key)
        elif entry[2]:
            return
        else:
            entry[2] = True
        self._collective("all-gather", "model", t.numel() * t.element_size(), axes - {_SP})

    def _hold(self, o, shares) -> None:
        """Count tensor ``o`` on its storage (``shares``: the storage's
        bytes per device when ``o`` allocated it, else ``None``)."""
        key = o.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            if shares is None:  # a view of an argument
                return
            entry = self._storages[key] = [0, shares, False]
            for i, b in enumerate(shares):
                self.live[i] += b
                if self.live[i] > self.peak[i]:
                    self.peak[i] = self.live[i]
        entry[0] += 1
        weakref.finalize(o, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            del self._storages[key]
            for i, b in enumerate(entry[1]):
                self.live[i] -= b

    def _contract(self, packet, args):
        ia, ib, ca, cb = _CONTRACTIONS[packet]
        a, b = args[ia], args[ib]
        (xa, wa), (xb, wb) = _tag(a), _tag(b)
        row = (wa is not None and "model" in wa[ca]) or (wb is not None and "model" in wb[cb])
        ea = frozenset().union(*wa) if wa is not None else xa
        eb = frozenset().union(*wb) if wb is not None else xb
        for t, e, other, w_other in ((a, ea, eb, wb), (b, eb, ea, wa)):
            if _SP in e and "model" not in e and not (w_other is None and _SP in other and "model" not in other):
                self._gather(t, e)
                if t is a:
                    ea = ea - {_SP}
                else:
                    eb = eb - {_SP}
        work = ea | eb
        out = work
        if row:
            out = (work - {"model", _SP}) | ({_SP} if self.sp else _EMPTY)
        return work, out, row

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        ins = []
        for a in args:
            if isinstance(a, torch.Tensor):
                ins.append(a)
            elif isinstance(a, (list, tuple)):
                ins.extend(x for x in a if isinstance(x, torch.Tensor))
        outs = [out] if isinstance(out, torch.Tensor) else [
            o for o in (out if isinstance(out, (list, tuple)) else ()) if isinstance(o, torch.Tensor)]
        wout = None
        reduce_out = False
        if packet in _CONTRACTIONS:
            work, axes, reduce_out = self._contract(packet, args)
        elif packet is _aten.index and ins and _tag(ins[0])[1] is not None and "model" in _tag(ins[0])[1][0]:
            # a lookup in a table split on its rows (the vocabulary): partial rows, reduced
            work = _tag(ins[0])[0] | frozenset().union(*(_tag(t)[0] for t in ins[1:]))
            axes = frozenset().union(*(_tag(t)[0] for t in ins[1:])) | ({_SP} if self.sp else _EMPTY)
            reduce_out = True
        else:
            work = frozenset().union(*(_tag(t)[0] for t in ins)) if ins else _EMPTY
            axes = work - {"model"} if _SP in work else work
            if len(ins) == 1 and _tag(ins[0])[1] is not None:
                wout = ins[0]
        divs = self._divisors(work)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = ins[-1].dtype if ins else torch.float32
            for fl, d in zip(self.flops, divs):
                fl[dt] = fl.get(dt, 0.0) + f / d
        view = func.is_view or packet in _NOCOPY
        if not view:
            nb = sum(t.numel() * t.element_size() for t in ins) + sum(o.numel() * o.element_size() for o in outs)
            for i, d in enumerate(divs):
                self.bytes[i] += nb / d
        fresh = [o for o in outs if not any(o is t for t in ins)]
        for o in fresh:
            o._dr = (axes, _weight_out(func, packet, wout, o, args) if wout is not None else None)
            self._hold(o, None if view else [o.numel() * o.element_size() / d for d in self._divisors(axes)])
        if reduce_out:
            kind = "reduce-scatter" if self.sp else "all-reduce"
            for o in outs:
                self._collective(kind, "model", o.numel() * o.element_size(), axes)
        return out


def _tag_leaf(t: torch.Tensor, logical: tuple, rules: Rules, weight: bool) -> torch.Tensor:
    dims, fsdp = [], set()
    fsdp_axes = set(_axes_of(rules.table.get("embed")))
    for name in logical:
        axes = set(_axes_of(rules.table.get(name))) if name else set()
        if weight and name == "embed":
            fsdp |= axes & fsdp_axes
            axes -= fsdp_axes
        dims.append(frozenset(axes))
    dims += [_EMPTY] * (t.dim() - len(dims))
    t._dr = (frozenset().union(*dims) | fsdp, tuple(dims) if weight else None)
    return t


def _meta_tree(group, rules: Rules, weight: bool):
    tree, logical = group
    specs = dict(flatten_with_path(logical, is_leaf=is_spec))
    leaves = [_tag_leaf(s.empty("meta"), specs[k], rules, weight) for k, s in flatten_with_path(tree)]
    return unflatten(tree, leaves) if not isinstance(tree, Spec) else leaves[0]


def _run_pass(cfg, shape, rules: Rules, meshes, opt_cfg) -> _Counter:
    cell = build_cell(cfg, shape)
    params = _meta_tree(cell["params"], rules, weight=True)
    counter = _Counter(meshes, rules.table.get("act_seq") is not None)
    if shape.kind == "train":
        ocfg = dataclasses.replace(opt_cfg, moment_dtype=cfg.optimizer_dtype, clip_mode="global_norm")
        opt = make_opt_state(params, ocfg)  # zeros beside each weight: tagged as the weights
        for group in ("m", "v"):
            opt[group] = tree_map(lambda z, p: setattr(z, "_dr", p._dr) or z, opt[group], params)
        batch = _meta_tree(cell["batch"], rules, weight=False)
        with counter:
            make_train_step(cfg, ocfg)(params, opt, batch)
    elif shape.kind == "prefill":
        batch = _meta_tree(cell["batch"], rules, weight=False)
        cache = _meta_tree(cell["cache"], rules, weight=False)
        with counter:
            prefill(cfg, params, batch, cache)
    else:
        cache = _meta_tree(cell["cache"], rules, weight=False)
        token = _meta_tree(cell["token"], rules, weight=False)
        with counter:
            decode_step(cfg, params, cache, token, shape.seq_len - 1)
    return counter


def _analytic_collectives(cfg, shape, rules: Rules, mesh: StandInMesh) -> dict:
    """The collectives of the placement that the pass does not meet
    (module docstring): FSDP gathers, the gradient reductions, the MoE
    all-to-alls and the decode combine, for the whole depth."""
    sizes = mesh.sizes
    out: dict = {}

    def add(kind, axis, nbytes):
        if sizes.get(axis, 1) > 1 and nbytes:
            out[(kind, axis)] = out.get((kind, axis), 0.0) + nbytes

    train = shape.kind == "train"
    fsdp = [a for a in _axes_of(rules.table.get("embed")) if a in sizes]
    batch_axes = [a for a in _axes_of(rules.table.get("act_batch")) if a in sizes]
    compute = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    uses = (2 + (cfg.remat_policy != "none")) if train else 1
    for _, s, logical in _pairs((_abstract_params(cfg), param_specs(cfg))):
        split = {a for e in rules(logical) for a in _axes_of(e)}
        tp = math.prod(sizes[a] for a in split - set(fsdp))
        n = math.prod(s.shape)
        if fsdp and "embed" in logical:  # a matrix: gathered in the compute dtype
            for a in fsdp:
                add("all-gather", a, uses * n * compute.itemsize / tp)
        if train:
            shard = n * 4 / math.prod(sizes[a] for a in split)
            if "embed" in logical:
                for a in fsdp:
                    add("reduce-scatter", a, shard)
            for a in batch_axes:
                if not ("embed" in logical and a in fsdp):
                    add("all-reduce", a, shard)
    B_loc = shape.global_batch / math.prod(sizes[a] for a in batch_axes) if batch_axes else shape.global_batch
    dt_b = compute.itemsize
    n_moe = cfg.repeats * sum("moe" in k for k in cfg.pattern)
    if n_moe and rules.table.get("experts") == "model":
        S = 1 if shape.kind.startswith("decode") else shape.seq_len
        g = min(cfg.moe_group_size, S * (shape.global_batch if S == 1 else 1))
        tokens = B_loc * S if S > 1 else B_loc
        cap = max(int(g * cfg.num_experts_per_token * cfg.moe_capacity_factor / cfg.num_experts), 1)
        slots = math.ceil(tokens / g) * cfg.num_experts * cap * cfg.d_model * dt_b / sizes["model"]
        add("all-to-all", "model", n_moe * 2 * slots * ((2 + (cfg.remat_policy != "none")) if train else 1))
    if shape.kind.startswith("decode"):
        n_attn = cfg.repeats * sum(k.split("+")[0] in ("attn", "local", "global") for k in cfg.pattern)
        B_c = shape.global_batch / math.prod(sizes[a] for a in _axes_of(rules.table.get("batch_kv")) if a in sizes)
        for a in _axes_of(rules.table.get("kv_seq")):
            add("all-reduce", a, n_attn * 4 * B_c * cfg.num_heads * (cfg.head_dim + 2))
    return out


def collective_record(coll: dict) -> dict:
    """The record's ``collectives``: output bytes and counts by kind, and
    bytes by kind and axis, of ``{(kind, axis): bytes}``."""
    rec = {c: 0.0 for c in COLLECTIVES}
    rec.update({f"n_{c}": 0 for c in COLLECTIVES})
    for (kind, axis), b in coll.items():
        rec[kind] += b
        rec[f"n_{kind}"] += 1
        rec[f"{kind}@{axis}"] = rec.get(f"{kind}@{axis}", 0.0) + b
    return rec


def _table_key(cfg, shape, mesh) -> tuple:
    """``Rules``' table with the "pod" axis left out: meshes of one key
    share a pass (a mesh without "pod" is one with "pod" of size 1)."""
    table = Rules(cfg, mesh, shape.kind, seq_len=shape.seq_len).table
    return tuple(sorted((k, tuple(a for a in _axes_of(v) if a != "pod")) for k, v in table.items()))


def measure(cfg, shape, meshes: list[StandInMesh], opt_cfg=None) -> list[dict]:
    """The per-device costs of one cell on each of ``meshes``.  One pass at
    depth 1 and one at depth 2 serve every mesh of one ``Rules`` table
    (up to "pod"), as the 16 × 16 and 2 × 16 × 16 meshes share theirs."""
    opt_cfg = opt_cfg or OptimizerConfig()
    groups: dict[tuple, list[int]] = {}
    for i, mesh in enumerate(meshes):
        groups.setdefault(_table_key(cfg, shape, mesh), []).append(i)
    R = cfg.repeats

    def extrap(v1, v2):
        return v1 + (R - 1) * max(v2 - v1, 0.0)

    out = [None] * len(meshes)
    for idx in groups.values():
        group = [meshes[i] for i in idx]
        tag_mesh = max(group, key=lambda m: len(m.mesh_dim_names))
        t0 = time.perf_counter()
        passes = []
        for r in (1, 2):
            pc = _pass_config(cfg, shape, r)
            passes.append(_run_pass(pc, shape, Rules(pc, tag_mesh, shape.kind, seq_len=shape.seq_len), group,
                                    opt_cfg))
        pass_s = time.perf_counter() - t0
        c1, c2 = passes
        for j, (i, mesh) in enumerate(zip(idx, group)):
            flops = {str(dt).replace("torch.", ""): extrap(c1.flops[j].get(dt, 0.0), c2.flops[j].get(dt, 0.0))
                     for dt in set(c1.flops[j]) | set(c2.flops[j])}
            compute_s = sum(f / _RATES.get(getattr(torch, dt), F32_FLOPS) for dt, f in flops.items())
            coll = {k: extrap(c1.coll[j].get(k, 0.0), c2.coll[j].get(k, 0.0))
                    for k in set(c1.coll[j]) | set(c2.coll[j])}
            rules = Rules(cfg, mesh, shape.kind, seq_len=shape.seq_len)
            for k, v in _analytic_collectives(cfg, shape, rules, mesh).items():
                coll[k] = coll.get(k, 0.0) + v
            out[i] = {
                "flops_by_dtype": flops,
                "flops": sum(flops.values()),
                "bytes": extrap(c1.bytes[j], c2.bytes[j]),
                "peak_live": extrap(c1.peak[j], c2.peak[j]),
                "collectives": coll,
                "compute_s": compute_s,
                "collective_s": sum(b / axis_bandwidth(mesh, axis) for (_, axis), b in coll.items()),
                "raw": {"r1": {"flops": sum(c1.flops[j].values()), "bytes": c1.bytes[j], "ops": c1.ops},
                        "r2": {"flops": sum(c2.flops[j].values()), "bytes": c2.bytes[j], "ops": c2.ops}},
                "pass_s": pass_s,
            }
    return out


COST_SOURCE = {
    "arguments": "exact: each leaf's shard under Rules (dimensions divided by their mesh axes, rounded up)",
    "flops": "torch.utils.flop_counter formulas over a meta-tensor pass of the port's step at depth 1 and 2, "
             "each op divided by the axes its inputs are split over, extrapolated to the depth",
    "bytes": "operand plus output bytes of every dispatched op of that pass (eager, no fusion, views free), "
             "divided and extrapolated alike",
    "temp": "largest live bytes of the pass's tensors, each divided as its axes split it, extrapolated, "
            "less the outputs",
    "collectives": "output bytes the placement implies (module docstring), priced per mesh axis",
}


def _output_bytes(cfg, shape, args: dict, rules, mesh) -> tuple[int, int]:
    """(output bytes, aliased bytes) per device, given the argument groups'
    bytes: train returns new parameters and optimizer state (nothing
    donated); prefill and decode return the last position's float32
    logits and the caches, written in place (aliased)."""
    if shape.kind == "train":
        return args["params"] + args["opt"], 0
    logits = Spec((shape.global_batch, 1, cfg.vocab_size), torch.float32)
    lb = _local_bytes(logits, ("act_batch", None, "vocab"), rules, mesh.sizes)
    return lb + args["cache"], args["cache"]


def run_cell(arch: str, shape_name, multi_pod: bool, opt_cfg=None, *, mesh: StandInMesh | None = None,
             costs: dict | None = None) -> dict:
    """The dry-run record of one cell (the reference's keys, plus
    ``cost_source`` and ``card``).  ``shape_name`` names a ``SHAPES`` entry
    or is a ``ShapeConfig``; ``mesh`` overrides the production mesh (the
    card check runs a 1 × 1 one); ``costs`` is this cell's :func:`measure`
    result when the caller has it already."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = mesh or production_mesh(multi_pod)
    record: dict = {"arch": arch, "shape": shape.name, "mesh": mesh.name, "kind": shape.kind, "card": CARD}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record["status"] = "skip"
        record["reason"] = reason
        return record
    t0 = time.perf_counter()
    rules = Rules(cfg, mesh, shape.kind, seq_len=shape.seq_len)
    cell = build_cell(cfg, shape)
    args = arguments(cell, rules, mesh)
    costs = costs or measure(cfg, shape, [mesh], opt_cfg)[0]
    out_b, alias = _output_bytes(cfg, shape, args, rules, mesh)
    arg_b = sum(args.values())
    temp = max(int(costs["peak_live"]) - (out_b - alias), 0)
    record.update(status="ok", compile_s=round(time.perf_counter() - t0, 1), degradations=rules.degradations())
    record["memory"] = {
        "argument_size_in_bytes": arg_b,
        "output_size_in_bytes": out_b,
        "temp_size_in_bytes": temp,
        "alias_size_in_bytes": alias,
        "peak_bytes_per_device": arg_b + out_b + temp - alias,
        "arguments_by_group": args,
    }
    record["cost_source"] = COST_SOURCE
    record["hlo_flops_per_device"] = costs["flops"]
    record["flops_by_dtype"] = costs["flops_by_dtype"]
    record["hlo_bytes_per_device"] = costs["bytes"]
    record["collectives"] = collective_record(costs["collectives"])
    record["costing_raw"] = costs["raw"]
    record["costing_s"] = round(costs["pass_s"], 1)
    model_flops = _model_flops(cfg, shape)
    record["model_flops_total"] = model_flops
    record["model_flops_per_device"] = model_flops / mesh.size
    t_memory = record["hlo_bytes_per_device"] / HBM_BW
    record["terms"] = {"compute_s": costs["compute_s"], "memory_s": t_memory, "collective_s": costs["collective_s"]}
    record["dominant"] = max(record["terms"], key=record["terms"].get)
    bound = max(record["terms"].values())
    record["roofline_step_s"] = bound
    record["useful_compute_ratio"] = (
        record["model_flops_per_device"] / record["hlo_flops_per_device"] if record["hlo_flops_per_device"] else 0.0
    )
    # model-FLOPs utilization *if* the dominant term were the runtime
    record["mfu_upper_bound"] = record["model_flops_per_device"] / (bound * PEAK_FLOPS) if bound else 0.0
    record["fits_device"] = record["memory"]["peak_bytes_per_device"] <= HBM_BYTES
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    for arch in archs:
        for shape_name in shapes:
            todo = {}
            for multi_pod in meshes:
                path = os.path.join(args.out, f"{arch}__{shape_name}__{production_mesh(multi_pod).name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {path}")
                else:
                    todo[multi_pod] = path
            if not todo:
                continue
            print(f"[dryrun] {arch} × {shape_name} × {', '.join(production_mesh(m).name for m in todo)} ...",
                  flush=True)
            cfg, shape = get_config(arch), SHAPES[shape_name]
            try:
                costs = None
                if shape_applicable(cfg, shape)[0]:
                    costs = dict(zip(todo, measure(cfg, shape, [production_mesh(m) for m in todo])))
                recs = {m: run_cell(arch, shape_name, m, costs=costs and costs[m]) for m in todo}
            except Exception as e:  # record the failure and go on to the next cell
                recs = {m: {"arch": arch, "shape": shape_name, "mesh": production_mesh(m).name, "status": "error",
                            "error": str(e), "traceback": traceback.format_exc()[-4000:]} for m in todo}
            for m, path in todo.items():
                rec = recs[m]
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    t = rec["terms"]
                    print(
                        f"  {rec['mesh']} ok costing={rec['costing_s']}s "
                        f"flops/dev={rec['hlo_flops_per_device']:.3e} "
                        f"peak={rec['memory']['peak_bytes_per_device'] / 1e9:.2f}GB "
                        f"terms(c/m/x)={t['compute_s']:.4f}/{t['memory_s']:.4f}/"
                        f"{t['collective_s']:.4f}s dominant={rec['dominant']} "
                        f"mfu_ub={rec['mfu_upper_bound']:.3f}",
                        flush=True,
                    )
                else:
                    print(f"  {rec['status']}: {rec.get('reason') or rec.get('error', '')[:500]}", flush=True)


if __name__ == "__main__":
    main()
