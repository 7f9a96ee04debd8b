"""Segment-tree interval engine over stored partition summaries.

PyTorch port of ``repro.core.interval_tree``: the same tree, node arena,
composed error bound and bit-exactness contract.  Every batched merge —
each tree level's pull-up and each query batch — is one call of the
port's batched merge kernel (:func:`merge_stacks`) on the tree's device;
node summaries and answers stay host NumPy, as in the reference.

Why a tree
----------
The paper's Merger answers "equi-depth histogram over partitions lo..hi" by
merging the stored per-partition ``T``-bucket summaries.  Done flat, every
query re-merges the whole window: ``O(W)`` summaries sorted per query, and a
fresh compile in the reference for every distinct window length ``k`` (the ``(k, T+1)``
merge shape is static).  This module maintains a power-of-two **segment
tree** over the partition axis instead:

    level 0   the stored leaf summaries (exact, ``T`` buckets)
    level l   one pre-merged ``T_node``-bucket summary per aligned pair of
              level-(l-1) nodes, i.e. node ``(l, i)`` summarizes partition
              slots ``[i·2^l, (i+1)·2^l)``

so any interval ``[lo, hi]`` decomposes into at most ``2·log2(W)`` canonical
nodes (the classic bottom-up cover), and a query merges only those:
``O(log W)`` summaries per query instead of ``O(W)``.  Node maintenance on
ingest is ``O(log W)`` pairwise merges; bulk (re)builds batch each level into
a single batched merge.

Node storage — the shared arena
-------------------------------
Node summaries do not own their arrays: every node is a lightweight
:class:`TreeNode` *handle* — a ``(arena, width, row)`` reference into a
pooled :class:`~repro_torch.core.arena.NodeArena` plane plus the error-bound
bookkeeping — and its ``boundaries``/``sizes`` are views of the pooled
rows.  One tree owns one arena by default; a multi-tenant registry can
hand every same-config tenant a single shared arena
(``TenantRegistry(shared_arena=True)``), which turns the cross-tenant
merge-stack pack into a single device gather (:func:`pack_device_rows`)
and lets a drained ingest batch pull up *all* touched trees with one
merge dispatch per level (:func:`pull_up_trees`).  Rows are write-once
and freed by handle garbage-collection, so an in-flight pack that holds
node handles can never observe a reused row — see the arena module
docstring for the slot-lifecycle contract.

Composed error bound (paper Theorem 1, applied per level)
---------------------------------------------------------
Theorem 1: merging ``k`` *exact* ``T``-bucket histograms of ``N`` total
values yields every bucket (and, Theorem 2, every contiguous bucket range)
within ``ε < 2N/T`` of ideal; integer-rounded inputs (``T ∤ |P_i|``) add a
``+2k`` slack.  The theorem composes recursively — the same fact the tile →
device → pod hierarchy exploits in ``core/distributed.py``: if the ``k``
inputs are themselves approximate with summary errors ``ε_i``, the output
error is bounded by

    ε_out  ≤  Σ_i ε_i  +  2N/T_in  +  2k                       (composition)

because the merge is exact w.r.t. the *claimed* input masses (±2N/T_in + 2k)
and the claims are off by at most Σ ε_i.  Each tree node therefore carries
its own accumulated bound: leaves have ``ε = 0``; an internal node built
from children with resolutions ``≥ T_in`` has

    ε_node = ε_left + ε_right + 2·n_node/T_in + 4 .

A query that merges canonical nodes {v} into β buckets reports

    ε_total = Σ_v ε_v + 2N/min_v T_v + 2·|{v}|
            < 2N · Σ_level 1/T_level  (+ integer slack),

the ``ε_total < 2N·Σ_level 1/T_level`` form of the module header, with
``T_level = T`` uniform giving ``ε_total < 2N·(1 + ⌈log2 W⌉)/T``.

**Geometric per-level resolution** (``geometric=True``): node resolution
doubles per level — a level-``l`` node holds ``T_node·2^l`` buckets — so the
per-level error terms form a geometric series and the composed bound
converges to ``ε_total < 4N/T_leaf`` *independent of depth*, at ``O(log W)``
extra memory per leaf (every level stores ``W·T`` bucket floats in total
instead of the uniform mode's ``W·T/2^l``).  Because a level-``l`` pair
merge emits exactly as many buckets as its two children jointly carry
boundaries, geometric nodes lose no resolution on the way up — the only
per-level error is the left-collapse term ``2n/T_in`` of the level below.
Exposed as ``HistogramStore(T_node="geometric")``.  In the arena layout
each level resolution is its own plane — the per-level views of the pool.

What is (and is not) bit-exact
------------------------------
The paper's merge is *lossy* (left-collapse repositions mass), so a
pre-merged internal node cannot reproduce the flat merge of its leaves
bit-for-bit — that is exactly why ε composes per level instead of being flat
``2N/T``.  What *is* bit-exact, proven below and asserted by
``tests/test_interval_tree.py``:

  * ``query`` ≡ ``merge_list`` over the selected canonical node summaries;
  * ``query_many`` (which pads every query's node set to one static
    ``(k_pad, T_pad)`` shape so a single batched merge serves the whole
    batch) ≡ per-query ``query``;
  * intervals whose canonical cover is all leaves (single partition, or any
    two-partition span crossing a pair boundary) ≡ the flat
    ``merge_list`` over the raw leaf summaries.

Padding invariance: inserting a zero-mass boundary at any value ``v`` inside
``[min, max]`` of the pre-histogram leaves every output bit unchanged.  With
the inserted element at sorted position ``p``, the cumulative array ``A``
gains a duplicate of ``A[p-1]``; for each cut target ``t_j``, either
``A[p-1] ≤ t_j`` (then ``cut_j`` shifts by exactly the one inserted slot and
``pos[cut_j]`` is unchanged) or ``A[p-1] > t_j`` (then ``cut_j`` indexes the
untouched prefix).  First/last output boundaries are the global min/max,
which zero-mass interior padding cannot displace.  Hence the per-node ``T``
padding, the per-query ``k`` padding (rows of zero-mass duplicates of a real
boundary — whether a repeated scalar or a full copy of a real row), and the
arena's stored row padding are all bit-exact, and the engine can pad node
sets to the next power of two for a bounded set of launch shapes.

Caching
-------
Answers are memoized in an LRU keyed ``(lo, hi, beta, version)`` where
``version`` bumps on every mutation — the hot dashboards-asking-the-same-
window path (millions of users, few distinct windows) is served from host
memory without touching the device at all.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis.witness import OrderedLock
from repro_torch.core.arena import NodeArena
from repro_torch.core.histogram import Histogram, as_tensor, next_pow2
from repro_torch.kernels import merge_batched

__all__ = [
    "TreeNode",
    "IntervalTree",
    "canonical_decomposition",
    "merge_stacks",
    "pack_node_rows",
    "pack_device_rows",
    "pull_up_trees",
    "selection_eps",
]

COLLAPSE_MODES = ("canonical", "amortized")

# Ingest-path merge observability (module-wide: the cross-tenant batched
# pull-up issues ONE dispatch per level for a whole drained batch, so the
# counter cannot live on any single tree).  Benchmarks read and reset these
# to machine-check the "one dispatch per level across tenants" claim and
# the amortized-collapse merge-work claim.
_COUNTER_LOCK = OrderedLock("tree.counters")
PULLUP_STATS = {"dispatches": 0, "pair_merges": 0}


def reset_pullup_stats() -> dict[str, int]:
    with _COUNTER_LOCK:
        out = dict(PULLUP_STATS)
        PULLUP_STATS["dispatches"] = 0
        PULLUP_STATS["pair_merges"] = 0
    return out


class TreeNode:
    """One tree node: an arena row handle plus error-bound bookkeeping.

    ``boundaries``/``sizes`` are NumPy views of the pooled row (valid while
    the handle is referenced — the arena frees the row when the last handle
    is garbage-collected, which is what makes concurrent eviction safe
    against in-flight packs).  ``src`` optionally remembers the caller's
    original leaf arrays so the store's pointer-identity staleness scan
    (``HistogramStore._sync_tree``) works without re-reading row data.
    """

    __slots__ = ("arena", "width", "row", "T", "n", "eps", "leaves", "src")

    def __init__(
        self,
        arena: NodeArena,
        width: int,
        row: int,
        T: int,
        n: float,
        eps: float,
        leaves: int,
        src: tuple | None = None,
    ):
        self.arena = arena
        self.width = width
        self.row = row
        self.T = T
        self.n = n
        self.eps = eps
        self.leaves = leaves
        self.src = src

    def __del__(self):  # pragma: no cover - exercised indirectly everywhere
        arena = getattr(self, "arena", None)
        if arena is not None:
            try:
                arena._dead.append((self.width, self.row))
            except Exception:
                pass  # interpreter shutdown

    @property
    def boundaries(self) -> np.ndarray:
        return self.arena.view(self.width, self.row)[0][: self.T + 1]

    @property
    def sizes(self) -> np.ndarray:
        return self.arena.view(self.width, self.row)[1][: self.T]

    @property
    def num_buckets(self) -> int:
        return self.T

    def to_histogram(self) -> Histogram:
        return Histogram(
            boundaries=torch.tensor(self.boundaries),
            sizes=torch.tensor(self.sizes),
        )


def canonical_decomposition(lo: int, hi: int) -> list[tuple[int, int]]:
    """Canonical segment-tree cover of leaf slots ``[lo, hi]`` (inclusive).

    Returns ``(level, index)`` keys, left-to-right, where node ``(l, i)``
    covers slots ``[i·2^l, (i+1)·2^l)``.  At most two nodes per level →
    ``≤ 2·⌈log2(hi-lo+1)⌉ + 1`` nodes total.
    """
    left: list[tuple[int, int]] = []
    right: list[tuple[int, int]] = []
    l, r = lo, hi + 1  # half-open
    level = 0
    while l < r:
        if l & 1:
            left.append((level, l))
            l += 1
        if r & 1:
            r -= 1
            right.append((level, r))
        l >>= 1
        r >>= 1
        level += 1
    return left + right[::-1]


def merge_stacks(bounds, sizes, beta: int, device=None):
    """Batched merge: ``(Q, k, T+1)``/``(Q, k, T)`` → ``(Q, β+1)``/``(Q, β)``.

    One launch of the batched merge kernel (``kernels/merge_cut.py``) on
    ``device`` (default: where ``bounds`` lies; host arrays are uploaded).
    Shared by every batched Merger path: the tree's own queries and its
    level maintenance.  Returns tensors on that device.
    """
    b = as_tensor(bounds, device).contiguous()
    s = as_tensor(sizes, b.device).contiguous()
    return merge_batched(b, s, int(beta))


def _gather_rows(pool_b, pool_s, idx, mask):
    """Device-side merge-stack assembly: ``(n_slots, W+1)`` pools + a
    ``(Q, k_pad)`` slot index → ``(Q, k_pad, W+1)``/``(Q, k_pad, W)``.
    Pad entries point at a real row with a zero mask, so they become the
    bit-exact zero-mass-duplicate pad rows of the host pack."""
    Q, k = idx.shape
    flat = idx.reshape(-1)
    return (
        pool_b.index_select(0, flat).reshape(Q, k, -1),
        pool_s.index_select(0, flat).reshape(Q, k, -1) * mask[:, :, None],
    )


def _scatter_rows(
    bounds: np.ndarray,
    sizes: np.ndarray,
    entries: Sequence[tuple[tuple, TreeNode]],
    T_pad: int,
) -> None:
    """Fill pre-zeroed ``(..., T_pad+1)``/``(..., T_pad)`` blocks from arena
    rows with one fancy-index copy per (arena, plane) instead of one copy +
    pad per node.  ``entries`` maps a block position (an index tuple) to a
    node; rows stored narrower than ``T_pad`` get the zero-mass tail pad,
    rows stored wider truncate (their tail is zero-mass padding already —
    both directions are the bit-exact padding rule of the module docstring).
    """
    groups: dict[tuple[int, int], list[tuple[tuple, TreeNode]]] = {}
    for pos, nd in entries:
        groups.setdefault((id(nd.arena), nd.width), []).append((pos, nd))
    for (_, width), items in groups.items():
        arena = items[0][1].arena
        bblock, sblock = arena.rows(width, [nd.row for _, nd in items])
        pos_idx = tuple(
            np.asarray([pos[d] for pos, _ in items])
            for d in range(len(items[0][0]))
        )
        w = min(width, T_pad)
        bounds[pos_idx + (slice(None, w + 1),)] = bblock[:, : w + 1]
        if T_pad > width:
            bounds[pos_idx + (slice(width + 1, None),)] = bblock[:, width:][
                :, -1:
            ]
        sizes[pos_idx + (slice(None, w),)] = sblock[:, :w]


def pack_node_rows(
    rows: Sequence[Sequence[TreeNode]],
    *,
    T_pad: int | None = None,
    pad_row_copy: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-query node sets into one ``(Q, k_pad, T_pad)`` block.

    ``k`` pads to the next power of two with rows of zero-mass duplicates of
    a real boundary; ``T`` pads merge_list-style.  Both are bit-exact (module
    docstring).  Rows may come from *different* trees (the cross-tenant
    registry path) — only the summary arrays matter.  The block is filled
    with one stacked fancy-index copy per (arena, plane) rather than one
    copy per node (the copies are still counted by the arenas'
    ``host_row_copies`` — the device gather path exists precisely to make
    that counter stay zero).

    ``T_pad`` overrides the padded bucket width (default: the widest
    selected node) — the registry's host path pads to the arena plane width
    so its block is bit-identical to the device gather's.  ``pad_row_copy``
    pads ``k`` with full zero-mass copies of the row's last real node
    (matching the gather) instead of the scalar last-boundary fill; both
    rules are bit-exact.

    An empty row packs to an all-zero-mass constant row: its merge output
    is well-defined but meaningless, so callers answering queries must
    filter empty selections first (``HistogramStore.query_many``
    (strict=False) returns the documented ``(None, inf)`` placeholder
    instead of dispatching them).
    """
    k_max = max((len(r) for r in rows), default=0)
    if k_max == 0:
        raise ValueError("pack_node_rows: every node row is empty")
    k_pad = next_pow2(k_max)
    if T_pad is None:
        T_pad = max(nd.num_buckets for r in rows for nd in r)
    Q = len(rows)
    bounds = np.zeros((Q, k_pad, T_pad + 1), np.float32)
    sizes = np.zeros((Q, k_pad, T_pad), np.float32)
    entries = [
        ((qi, ki), nd) for qi, r in enumerate(rows) for ki, nd in enumerate(r)
    ]
    _scatter_rows(bounds, sizes, entries, T_pad)
    for qi, r in enumerate(rows):
        if r and len(r) < k_pad:
            # zero-mass pad rows built from this query's last real row
            # (already padded to T_pad in the block)
            last = bounds[qi, len(r) - 1]
            bounds[qi, len(r) :] = last if pad_row_copy else last[-1]
    return bounds, sizes


def pack_device_rows(rows: Sequence[Sequence[TreeNode]]):
    """Zero-host-copy merge-stack pack: one device gather over a shared
    arena plane.

    Requires every selected node to live in the same plane of the same
    arena (true for any uniform-``T_node`` registry with a shared arena —
    the default configuration); returns ``None`` otherwise so the caller
    falls back to the host pack.  The produced block is bit-identical to
    ``pack_node_rows(rows, T_pad=width, pad_row_copy=True)``: same rows,
    same zero-mass pad rows, assembled device-side from the plane's
    resident snapshot instead of copied row by row on the host.

    The caller must keep holding the node handles until the merge output is
    materialized — that reference is what pins the rows against concurrent
    eviction + reuse (arena module docstring).
    """
    first: TreeNode | None = None
    k_max = 0
    for r in rows:
        if len(r) > k_max:
            k_max = len(r)
        for nd in r:
            if first is None:
                first = nd
            elif nd.arena is not first.arena or nd.width != first.width:
                return None
    if first is None:
        raise ValueError("pack_device_rows: every node row is empty")
    k_pad = next_pow2(k_max)
    Q = len(rows)
    idx = np.zeros((Q, k_pad), np.int32)
    mask = np.zeros((Q, k_pad), np.float32)
    for qi, r in enumerate(rows):
        k = len(r)
        if k:
            idx[qi, :k] = [nd.row for nd in r]
            idx[qi, k:] = r[-1].row
            mask[qi, :k] = 1.0
    pool_b, pool_s = first.arena.device(first.width)
    dev = pool_b.device
    return _gather_rows(
        pool_b, pool_s, torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    )


def selection_eps(sel: Sequence[TreeNode]) -> float:
    """Composed ``ε_total`` of merging the canonical nodes ``sel`` (module
    docstring): accumulated per-node bounds + one more Theorem-1 level.
    One fused pass — this runs per query on the serving path."""
    n = 0.0
    eps = 0.0
    T_in = sel[0].T
    for nd in sel:
        n += nd.n
        eps += nd.eps
        if nd.T < T_in:
            T_in = nd.T
    return float(eps + 2.0 * n / T_in + 2.0 * len(sel))


def _merge_pairs_multi(
    entries: Sequence[tuple["IntervalTree", int, Sequence[int]]]
) -> None:
    """Merge sibling pairs across one or many trees with one batched
    dispatch per output resolution, writing the parent nodes (with their
    composed-ε bookkeeping) straight into the trees' arenas.

    ``entries`` holds ``(tree, level, pair_indices)`` jobs; same-config
    trees at the same level share an output resolution, so a whole drained
    cross-tenant ingest batch costs **one merge dispatch per level** — not
    one per tenant per level.  Node summaries are a pure function of the
    child summaries, so batch composition cannot change a single output
    bit (the determinism fact the retention tests pin).
    """
    jobs: dict[int, list] = {}
    for tree, level, pairs in entries:
        T_out = tree.node_T(level)
        for i in pairs:
            c0 = tree.nodes[(level - 1, 2 * i)]
            c1 = tree.nodes[(level - 1, 2 * i + 1)]
            jobs.setdefault(T_out, []).append((tree, level, i, c0, c1))
    for T_out, work in jobs.items():
        Q = len(work)
        Q_pad = next_pow2(Q)
        T_in = max(
            max(c0.num_buckets, c1.num_buckets) for _, _, _, c0, c1 in work
        )
        bs = np.zeros((Q_pad, 2, T_in + 1), np.float32)
        ss = np.zeros((Q_pad, 2, T_in), np.float32)
        scatter = []
        for q, (_, _, _, c0, c1) in enumerate(work):
            scatter.append(((q, 0), c0))
            scatter.append(((q, 1), c1))
        for q in range(Q, Q_pad):  # pad the batch with the last real pair
            scatter.append(((q, 0), work[-1][3]))
            scatter.append(((q, 1), work[-1][4]))
        _scatter_rows(bs, ss, scatter, T_in)
        with _COUNTER_LOCK:
            PULLUP_STATS["dispatches"] += 1
            PULLUP_STATS["pair_merges"] += Q
        # one batched merge kernel launch per output resolution; the
        # result reaches host NumPy before the caller releases its locks
        bo, so = merge_stacks(bs, ss, T_out, device=work[0][0].arena.torch_device)
        bo, so = bo.cpu().numpy(), so.cpu().numpy()
        # write merge outputs straight into arena rows: one block alloc per
        # destination arena (a shared arena takes one for ALL tenants)
        by_arena: dict[int, list[int]] = {}
        for q, (tree, _, _, _, _) in enumerate(work):
            by_arena.setdefault(id(tree.arena), []).append(q)
        for qs in by_arena.values():
            arena = work[qs[0]][0].arena
            rows = arena.alloc_block(T_out, bo[qs], so[qs])
            for q, row in zip(qs, rows):
                tree, level, i, c0, c1 = work[q]
                n = c0.n + c1.n
                t_in = min(c0.num_buckets, c1.num_buckets)
                tree.nodes[(level, i)] = TreeNode(
                    arena,
                    T_out,
                    row,
                    T_out,
                    n,
                    c0.eps + c1.eps + 2.0 * n / t_in + 4.0,
                    c0.leaves + c1.leaves,
                )


def pull_up_trees(work: Sequence[tuple["IntervalTree", set[int]]]) -> None:
    """Refresh the ancestor paths of dirty leaf slots across one or many
    trees, level by level, batching every tree's pair merges at a level
    into one dispatch (:func:`_merge_pairs_multi`).

    The single-tree case is :meth:`IntervalTree._pull_up_many`; the
    multi-tree case is the registry's cross-tenant batched apply (all
    touched stores' locks held by the caller).  Does NOT bump versions —
    callers invalidate once per batch.
    """
    states = [[tree, set(dirty)] for tree, dirty in work if dirty]
    if not states:
        return
    for level in range(1, max(tree.levels for tree, _ in states) + 1):
        entries = []
        for state in states:
            tree, parents = state
            if level > tree.levels:
                continue
            parents = {s >> 1 for s in parents}
            state[1] = parents
            pairs = [
                i
                for i in sorted(parents)
                if (level - 1, 2 * i) in tree.nodes
                and (level - 1, 2 * i + 1) in tree.nodes
            ]
            pair_set = set(pairs)
            for i in sorted(parents):
                if i not in pair_set:
                    tree._update(level, i)
            if pairs:
                entries.append((tree, level, pairs))
        if entries:
            _merge_pairs_multi(entries)


class IntervalTree:
    """Power-of-two segment tree of pre-merged partition summaries."""

    def __init__(
        self,
        T_node: int,
        cache_size: int = 128,
        *,
        geometric: bool = False,
        arena: NodeArena | None = None,
        collapse: str = "canonical",
        device: str | torch.device = "cuda",
    ):
        if T_node < 1:
            raise ValueError("T_node must be >= 1")
        if collapse not in COLLAPSE_MODES:
            raise ValueError(
                f"unknown collapse mode: {collapse!r} (use one of "
                f"{COLLAPSE_MODES})"
            )
        self.T_node = int(T_node)
        self.geometric = bool(geometric)
        # pooled node storage: own arena by default, or a registry-shared
        # one (core/arena.py) so same-config trees pack with one gather
        # the merge kernels run on the arena's device
        self.arena = arena if arena is not None else NodeArena(device)
        # eviction collapse policy: "canonical" keeps the post-eviction
        # tree bit-identical to a fresh build over the survivors (O(W)
        # merge work per window slide); "amortized" defers the re-root
        # until the dead slot prefix exceeds half the capacity — O(log W)
        # amortized merge work per ingest, answers still within eps_total
        # but no longer bit-equal to a fresh rebuild (see _collapse)
        self.collapse_mode = collapse
        self.levels = 0  # capacity = 2**levels leaf slots
        self.base: int | None = None  # partition id of slot 0
        self.nodes: dict[tuple[int, int], TreeNode] = {}
        self.version = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # query-path merge dispatch observability (summarize_shapes-style):
        # every cache-missing query batch adds one dispatch + its shape
        self.merge_dispatches = 0
        self.merge_shapes: set[tuple[int, int, int, int]] = set()
        self._cache: OrderedDict[tuple, tuple[Histogram, float]] = (
            OrderedDict()
        )
        self._cache_size = int(cache_size)

    # ------------------------------------------------------------ structure
    @property
    def capacity(self) -> int:
        return 1 << self.levels

    def node_T(self, level: int) -> int:
        """Merge-output resolution of a level-``level`` node: uniform
        ``T_node``, or ``T_node·2^level`` in geometric mode."""
        return self.T_node << level if self.geometric else self.T_node

    def num_leaves(self) -> int:
        return sum(1 for (lvl, _) in self.nodes if lvl == 0)

    def node_floats(self) -> int:
        """Total logical floats held by node summaries, counting shared
        rows once.

        Single-child internal nodes *share* their child's arena row, so
        the footprint is deduplicated by row identity — this is the
        store's memory figure that
        :class:`~repro_torch.core.retention.MemoryBudget` and the registry's
        cross-tenant budget act on (logical, un-padded widths, so budget
        calibrations are layout-independent; the *resident* pool size is
        ``arena.allocated_floats()``/``capacity_floats()``).
        """
        seen: set[tuple[int, int]] = set()
        total = 0
        for nd in self.nodes.values():
            key = (nd.width, nd.row)
            if key in seen:
                continue
            seen.add(key)
            total += 2 * nd.T + 1
        return total

    def _invalidate(self) -> None:
        self.version += 1
        self._cache.clear()

    # ---------------------------------------------------------- maintenance
    def _new_leaf(
        self, b: np.ndarray, s: np.ndarray, src: tuple | None = None
    ) -> TreeNode:
        """Copy one leaf summary into the arena (plane = its own logical
        width) and return its handle, remembering the source arrays for
        the store's pointer-identity staleness scan.  ``src`` carries a
        pre-existing identity token through rebuilds — losing it would
        make the first post-rebuild query mark every leaf stale and
        rebuild the whole tree a second time."""
        T = s.shape[-1]
        row = self.arena.alloc(T, b, s)
        return TreeNode(
            self.arena,
            T,
            row,
            T,
            float(s.sum()),
            0.0,
            1,
            src=src if src is not None else (b, s),
        )

    def set_leaf(self, partition_id: int, boundaries, sizes) -> None:
        """Insert/replace one leaf and refresh its ``O(log W)`` ancestors."""
        self.set_leaves({int(partition_id): (boundaries, sizes)})

    def set_leaves(
        self, leaves: dict[int, tuple[np.ndarray, np.ndarray]]
    ) -> None:
        """Insert/replace a batch of leaves with one level-batched pull-up.

        The ancestor paths of all ``k`` leaves are deduplicated per level and
        each level's pair merges go through one batched merge kernel launch —
        ``O(log W)`` kernel launches per batch instead of per leaf.  This is
        the per-flush maintenance path of the async Summarizer; a single
        mutation (``set_leaf``) is the ``k = 1`` case.  Cache invalidation
        (and the version bump) happens once per batch.
        """
        if not leaves:
            return
        dirty = self._write_leaves(leaves)
        if dirty is None:  # base-shift path rebuilt (and invalidated)
            return
        self._pull_up_many(dirty)
        self._invalidate()

    def _write_leaves(
        self, leaves: dict[int, tuple[np.ndarray, np.ndarray]]
    ) -> set[int] | None:
        """Write leaf rows + grow capacity; return the dirty slot set for
        the caller's pull-up (the registry batches pull-ups across trees),
        or ``None`` when a below-base id forced a full rebuild here."""
        pids = sorted(int(p) for p in leaves)
        if self.base is None:
            self.base = pids[0]
        if pids[0] < self.base:
            # a partition id below base arrived: shift every slot (rare);
            # surviving leaves keep their src identity through the rebuild
            merged = {
                self.base + slot: (nd.boundaries, nd.sizes, nd.src)
                for (lvl, slot), nd in self.nodes.items()
                if lvl == 0
            }
            merged.update({int(p): v for p, v in leaves.items()})
            self.rebuild(merged)
            return None
        grew = False
        while pids[-1] - self.base >= self.capacity:
            self.levels += 1
            grew = True
        dirty: set[int] = set()
        for pid in pids:
            slot = pid - self.base
            b = np.asarray(leaves[pid][0], np.float32)
            s = np.asarray(leaves[pid][1], np.float32)
            self.nodes[(0, slot)] = self._new_leaf(b, s)
            dirty.add(slot)
        if grew:
            # growth re-roots: the old root gains new ancestors on slot 0's
            # path (which the dirty-slot paths only share from some level up)
            dirty.add(0)
        return dirty

    def adopt_leaf_arrays(self, partition_id: int, boundaries, sizes) -> bool:
        """Re-point a leaf's staleness token at equal-valued external arrays
        without recompute.

        Used after :meth:`from_state` so tree leaves are identity-linked to
        the caller's summary rows — the pointer-identity staleness checks
        then pass without re-merging anything.  Returns False (no-op) when
        the leaf is absent or the arrays don't match the stored values.
        """
        if self.base is None:
            return False
        key = (0, int(partition_id) - self.base)
        nd = self.nodes.get(key)
        if (
            nd is None
            or not isinstance(boundaries, np.ndarray)
            or not isinstance(sizes, np.ndarray)
            or boundaries.dtype != nd.boundaries.dtype
            or not np.array_equal(boundaries, nd.boundaries)
            or not np.array_equal(sizes, nd.sizes)
        ):
            return False
        nd.src = (boundaries, sizes)
        return True

    def _pull_up_many(self, dirty: set[int]) -> None:
        """Refresh the deduplicated ancestor paths of the given leaf slots,
        level by level, batching each level's pair merges into one batched
        launch (padded to a power-of-two batch for a bounded
        set of launch shapes)."""
        pull_up_trees([(self, dirty)])

    def _update(self, level: int, idx: int) -> None:
        c0 = self.nodes.get((level - 1, 2 * idx))
        c1 = self.nodes.get((level - 1, 2 * idx + 1))
        key = (level, idx)
        if c0 is None and c1 is None:
            self.nodes.pop(key, None)
        elif c0 is None or c1 is None:
            # single child: share its summary (same handle, same arena
            # row) — no merge, no added error
            self.nodes[key] = c0 if c1 is None else c1
        else:
            self._merge_level(level, [idx])

    def _merge_level(self, level: int, pairs: Sequence[int]) -> None:
        """Merge the sibling pairs under ``(level, i) for i in pairs`` with a
        single batched dispatch — the one-tree case of
        :func:`_merge_pairs_multi`."""
        _merge_pairs_multi([(self, level, pairs)])

    def evict_leaves(self, partition_ids) -> int:
        """Remove leaf summaries — :meth:`set_leaf`'s pull-up in reverse.

        The evicted slots' ancestor paths are refreshed with the same
        level-batched machinery as ingest (``_pull_up_many``: a parent left
        with both children re-merges in the level batch, one child shares
        its summary, none frees its row), then the tree **lazily
        collapses**: fully-evicted leading subtrees are dropped in one pass
        so the root re-anchors at the lowest surviving leaf (see
        :meth:`_collapse`).  One version bump per batch — every LRU-cached
        answer keyed on the old version can never serve evicted data.
        Dropped rows return to the arena free list as soon as their last
        handle dies (never while an in-flight pack still holds one).

        Returns the number of leaves actually removed (absent ids are
        ignored, so a policy may re-list already-evicted partitions).
        """
        if self.base is None:
            return 0
        dirty: set[int] = set()
        for pid in partition_ids:
            slot = int(pid) - self.base
            if (0, slot) in self.nodes:
                del self.nodes[(0, slot)]
                dirty.add(slot)
        if not dirty:
            return 0
        self._collapse(dirty)
        self._invalidate()
        return len(dirty)

    def _collapse(self, dirty: set[int]) -> None:
        """Lazy subtree collapse: re-root the tree at the smallest subtree
        whose slot range starts at the lowest surviving leaf.

        Eviction from an infinite stream always removes a *prefix* of the
        partition axis, so without collapse ``slot = pid - base`` (and with
        it tree depth and, in geometric mode, per-node resolution) would
        grow without bound.  Two paths, both batched per eviction sweep
        rather than per leaf:

        * **aligned rename** — when the survivors fit an aligned subtree
          ``(L, j)`` starting exactly at the lowest surviving slot, that
          subtree becomes the root by re-keying its nodes (zero merges;
          the single-child chain above it is dropped, freeing rows whose
          storage was shared anyway);
        * **rebase-rebuild** — when the survivors straddle an alignment
          boundary, they are re-based to slot 0 with one level-batched
          :meth:`rebuild`.  Under geometric ``T_node`` this is what
          *re-coarsens* the surviving ancestors: pair merges now happen at
          the shallow tree's levels, with resolution ``T·2^l`` for the new
          small ``l`` instead of the deep tree's.

        Either way the post-collapse tree is **bit-identical to a fresh
        build over the surviving leaves** (same base, minimal depth, and
        node summaries are a deterministic function of the slot→leaf map),
        which is what keeps post-eviction queries bit-exact vs a flat
        rebuild of the retained window (tests/test_retention_props.py).

        Cost, stated plainly: that bit-equality contract is what forces
        the rebuild path in the sliding-window steady state.  A window
        sliding by one shifts every slot by one, which re-pairs *every*
        level — a fresh build after the shift shares no internal node
        with the old tree — so any implementation honouring the contract
        re-merges O(window) pairs per slide.  The level batching keeps it
        at O(log W) *dispatches* (the dominant cost in the serving
        regime, per-dispatch overhead being ~50-70 µs against tiny
        per-pair merges).

        **Amortized mode** (``collapse="amortized"``): the re-root is
        deferred while the dead slot prefix is smaller than half the
        capacity — eviction then costs only the reverse pull-up of the
        evicted paths (O(log W) merges), and the O(W) re-root runs once
        per ~W/2 evictions, i.e. O(log W) *amortized* merge work per
        ingest for a high-frequency sliding window.  The trade, stated in
        the retention contract's terms: between re-roots the tree is
        deeper than a fresh build over the survivors (up to one extra
        level, plus the uncollapsed dead prefix), so answers are NOT
        bit-equal to a fresh rebuild — they remain exactly correct
        per-node merges whose reported ``eps_total`` still dominates the
        measured error (property-tested), just composed over a slightly
        deeper selection.
        """
        slots = sorted(s for (lvl, s) in self.nodes if lvl == 0)
        if not slots:
            self.nodes.clear()
            self.base = None
            self.levels = 0
            return
        lo, hi = slots[0], slots[-1]
        if self.collapse_mode == "amortized" and lo < (self.capacity >> 1):
            # dead prefix still below the slack threshold: defer the
            # re-root, just refresh the evicted slots' ancestor paths
            self._pull_up_many(dirty)
            return
        L = self.levels
        while L > 0 and (lo >> (L - 1)) == (hi >> (L - 1)):
            L -= 1
        j = lo >> L
        if (j << L) == lo:
            # no collapse (already rooted at slot 0, minimal depth) or an
            # aligned rename: either way the surviving ancestors stay, so
            # refresh the evicted slots' paths (the reverse pull-up) first
            self._pull_up_many(dirty)
            if not (lo == 0 and L == self.levels):
                # subtree (L, j) becomes the root by re-keying, no merges
                self.nodes = {
                    (lvl, i - (j << (L - lvl))): nd
                    for (lvl, i), nd in self.nodes.items()
                    if lvl <= L
                }
                self.base += j << L
                self.levels = L
        else:
            # straddling survivors: one level-batched rebase-rebuild from
            # the (untouched) leaf rows — every ancestor is recomputed, so
            # the reverse pull-up would be wasted dispatches here.  The
            # leaves carry their src identity so the store's staleness
            # scan does not re-rebuild everything on the next query
            leaves = {
                self.base + s: (nd.boundaries, nd.sizes, nd.src)
                for (lvl, s), nd in self.nodes.items()
                if lvl == 0
            }
            self.base = None
            self.rebuild(leaves)

    def rebuild(self, leaves: dict[int, tuple]) -> None:
        """Bulk (re)build from ``{partition_id: (boundaries, sizes)}``
        (an optional third tuple element carries a leaf's existing ``src``
        identity token through the rebuild — the collapse/rebase paths
        use it so post-rebuild staleness scans still pass).

        Level-by-level: all sibling pairs of a level go through *one*
        batched merge launch, so a ``W``-partition build costs ``log2 W``
        kernel launches instead of ``W·log2 W`` (the incremental path's
        cost when used for bulk loads).
        """
        # callers may pass views of the current nodes' rows (the collapse
        # rebase path does) — keep the old handles alive until the new
        # rows are written, so the arena cannot reuse their slots mid-copy
        old_nodes = self.nodes  # noqa: F841  (lifetime anchor)
        self.nodes = {}
        self._invalidate()
        if not leaves:
            self.base = None
            self.levels = 0
            return
        pids = sorted(leaves)
        if self.base is None or pids[0] < self.base:
            self.base = pids[0]
        span = pids[-1] - self.base + 1
        self.levels = (span - 1).bit_length() if span > 1 else 0
        for pid in pids:
            val = leaves[pid]
            b = np.asarray(val[0], np.float32)
            s = np.asarray(val[1], np.float32)
            src = val[2] if len(val) > 2 else None
            self.nodes[(0, pid - self.base)] = self._new_leaf(b, s, src)
        self._pull_up_many({pid - self.base for pid in pids})

    # -------------------------------------------------------------- queries
    def decompose(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """Present canonical node keys covering partition ids ``lo..hi``."""
        if self.base is None:
            return []
        s_lo = max(int(lo) - self.base, 0)
        s_hi = min(int(hi) - self.base, self.capacity - 1)
        if s_hi < s_lo:
            return []
        return [
            k for k in canonical_decomposition(s_lo, s_hi) if k in self.nodes
        ]

    def _selected(self, lo: int, hi: int) -> list[TreeNode]:
        sel = [self.nodes[k] for k in self.decompose(lo, hi)]
        if not sel:
            raise KeyError("no partition summaries in requested interval")
        return sel

    def _cache_get(self, key: tuple) -> tuple[Histogram, float] | None:
        """LRU lookup; counts (and refreshes) a hit, leaves misses to the
        caller — shared by query/query_many and the cross-tenant registry."""
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.cache_hits += 1
        return hit

    def _cache_put(self, key: tuple, out: tuple[Histogram, float]) -> None:
        self._cache[key] = out
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

    def _dispatch(
        self, rows: Sequence[Sequence[TreeNode]], beta: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """One counted merge dispatch over packed node rows.

        Returns host arrays: one device→host transfer for the whole batch
        beats ``Q`` lazy per-row device slices by orders of magnitude when
        answers are unpacked row by row.
        """
        bounds, sizes = pack_node_rows(rows)
        self.merge_dispatches += 1
        self.merge_shapes.add(bounds.shape + (int(beta),))
        bo, so = merge_stacks(bounds, sizes, int(beta), device=self.arena.torch_device)
        return bo.cpu().numpy(), so.cpu().numpy()

    def query(self, lo: int, hi: int, beta: int) -> tuple[Histogram, float]:
        """β-bucket histogram over ``lo..hi`` plus its composed ``ε_total``.

        Merges only the ``≤ 2·log2 W`` canonical node summaries; answers are
        LRU-cached until the next mutation.
        """
        key = (int(lo), int(hi), int(beta), self.version)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        self.cache_misses += 1
        sel = self._selected(lo, hi)
        bo, so = self._dispatch([sel], beta)
        out = (Histogram(bo[0], so[0]), selection_eps(sel))
        self._cache_put(key, out)
        return out

    def query_many(
        self, intervals: Sequence[tuple[int, int]], beta: int
    ) -> list[tuple[Histogram, float]]:
        """Answer many interval queries with at most one batched merge.

        The LRU answer cache is consulted *per interval* first (a repeated
        dashboard batch costs zero dispatches and counts its hits exactly
        like :meth:`query`); only the misses — deduplicated, so the same
        window twice in one batch merges once — are padded to a single
        static ``(k_pad, T_pad)`` shape and served by one merge launch
        regardless of the mix of window lengths, then cached for the next
        batch.
        """
        if not intervals:
            return []
        keys = [
            (int(lo), int(hi), int(beta), self.version)
            for lo, hi in intervals
        ]
        answers: dict[tuple, tuple[Histogram, float]] = {}
        miss_keys: list[tuple] = []
        pending: set[tuple] = set()  # dedups repeated misses in this batch
        for key in keys:
            if key in answers or key in pending:
                continue
            hit = self._cache_get(key)
            if hit is not None:
                answers[key] = hit
            else:
                self.cache_misses += 1
                pending.add(key)
                miss_keys.append(key)
        if miss_keys:
            sels = [self._selected(k[0], k[1]) for k in miss_keys]
            bo, so = self._dispatch(sels, beta)
            for i, (key, sel) in enumerate(zip(miss_keys, sels)):
                out = (Histogram(bo[i], so[i]), selection_eps(sel))
                answers[key] = out
                self._cache_put(key, out)
        return [answers[key] for key in keys]

    # ---------------------------------------------------------- persistence
    def state(
        self, slot_map: dict[tuple[int, int], int] | None = None
    ) -> tuple[dict, dict[str, np.ndarray]]:
        """(json-able meta, arrays) for npz persistence of the tree nodes.

        The arena layout persists the *pools*, compacted: ``ab_{width}`` /
        ``as_{width}`` blocks holding only the live (referenced) rows, with
        per-node ``[lvl, idx, n, eps, leaves, T, width, slot]`` records
        pointing into them — free-list fragmentation never reaches disk,
        and shared rows are written once.  With ``slot_map`` given (the
        registry's shared-arena save), the caller already exported the
        pools for *all* tenants at once and this tree emits only its node
        records against that map.
        """
        own_export = slot_map is None
        arrays: dict[str, np.ndarray] = {}
        if own_export:
            arrays, slot_map = self.arena.export(
                (nd.width, nd.row) for nd in self.nodes.values()
            )
        meta = {
            "T_node": self.T_node,
            "geometric": self.geometric,
            "layout": "arena/v1",
            "shared_pool": not own_export,
            "base": self.base,
            "levels": self.levels,
            "nodes": [
                [
                    lvl,
                    idx,
                    nd.n,
                    nd.eps,
                    nd.leaves,
                    nd.T,
                    nd.width,
                    slot_map[(nd.width, nd.row)],
                ]
                for (lvl, idx), nd in sorted(self.nodes.items())
            ],
        }
        return meta, arrays

    @classmethod
    def from_state(
        cls,
        meta: dict,
        arrays,
        cache_size: int = 128,
        *,
        arena: NodeArena | None = None,
        collapse: str = "canonical",
        device: str | torch.device = "cuda",
    ):
        tree = cls(
            int(meta["T_node"]),
            cache_size=cache_size,
            geometric=bool(meta.get("geometric", False)),
            arena=arena,
            collapse=collapse,
            device=device,
        )
        tree.base = None if meta["base"] is None else int(meta["base"])
        tree.levels = int(meta["levels"])
        if meta.get("layout") != "arena/v1":
            # pre-arena summary files: one tb_/ts_ array pair per node
            for lvl, idx, n, eps, leaves in meta["nodes"]:
                lvl, idx = int(lvl), int(idx)
                b = np.asarray(arrays[f"tb_{lvl}_{idx}"], np.float32)
                s = np.asarray(arrays[f"ts_{lvl}_{idx}"], np.float32)
                T = s.shape[-1]
                row = tree.arena.alloc(T, b, s)
                tree.nodes[(lvl, idx)] = TreeNode(
                    tree.arena, T, row, T, float(n), float(eps), int(leaves)
                )
            return tree
        pools: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        handles: dict[tuple[int, int], TreeNode] = {}
        for lvl, idx, n, eps, leaves, T, width, slot in meta["nodes"]:
            lvl, idx, T, width, slot = (
                int(lvl),
                int(idx),
                int(T),
                int(width),
                int(slot),
            )
            nd = handles.get((width, slot))
            if nd is None:
                if width not in pools:
                    pools[width] = (
                        np.asarray(arrays[f"ab_{width}"], np.float32),
                        np.asarray(arrays[f"as_{width}"], np.float32),
                    )
                pb, ps = pools[width]
                # exported rows are width-padded; alloc re-pads the logical
                # prefix identically, so the live row is bit-identical
                row = tree.arena.alloc(width, pb[slot, : T + 1], ps[slot, :T])
                nd = TreeNode(
                    tree.arena,
                    width,
                    row,
                    T,
                    float(n),
                    float(eps),
                    int(leaves),
                )
                handles[(width, slot)] = nd
            tree.nodes[(lvl, idx)] = nd
        return tree
