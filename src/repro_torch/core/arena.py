"""Shared node-storage arena: one pooled ``(n_slots, T)`` layout for trees.

Why an arena
------------
The paper's merge framework treats every partition/node summary as an
identical ``(T+1 boundaries, T sizes)`` record — exactly the shape
homogeneity a pooled, columnar (SoA) layout exploits.  Before this module,
every :class:`~repro_torch.core.interval_tree.TreeNode` owned its own little pair
of NumPy arrays: thousands of same-shape trees (one per tenant of a
:class:`~repro_torch.core.tenant.TenantRegistry`) meant hundreds of thousands of
tiny heap allocations, and every cross-tenant ``query_many`` re-packed its
merge stack host-side, row by row — the same row-at-a-time materialization
trap PR 3 killed on the *output* path, still alive on the *input* path.

A :class:`NodeArena` instead holds a small number of **planes** — one pool
pair per row width ``W`` (number of buckets):

    boundaries pool   (capacity, W + 1)  float32
    sizes pool        (capacity, W)      float32

A node is then just a ``(width, row)`` reference into its plane; the
handle class (:class:`~repro_torch.core.interval_tree.TreeNode`) carries that
reference plus the error-bound bookkeeping, and its ``boundaries`` /
``sizes`` properties are NumPy views of the pooled rows.  Uniform
``T_node`` trees live entirely in one plane; geometric ``T_node`` uses one
plane per level resolution (``T·2^l``) — the per-level views of the pool.

Rows are stored **pre-padded** to the plane width with the merge-exact
padding rule (zero-mass copies of the last real boundary — bit-exactness
argument in interval_tree.py's module docstring), so packing a merge stack
from the arena needs no per-row padding work at all:

* **host pack** — selected rows materialize with ONE fancy-index copy per
  plane (:meth:`rows`) instead of one copy + pad per row;
* **device pack** — :meth:`device` keeps a device-resident snapshot of
  each plane (rebuilt only when the plane version moved), so a whole
  cross-tenant merge stack is assembled with a single ``index_select`` gather
  (:func:`pack_device_rows`): zero host-side row copies, zero per-tenant
  transfers.  :attr:`host_row_copies` counts every host-side row
  materialization (mirroring the ``merge_dispatches`` observability
  idiom), so "the gather path copies nothing on the host" is a
  machine-checked claim, not a comment.

Slot lifecycle (the design note)
--------------------------------
Allocation is free-list + geometric growth: ``alloc``/``alloc_block`` pop
free rows (growing the plane ×2 when empty), write the row data **once**,
and return row indices.  Rows are *write-once*: replacing a leaf or
re-merging an internal node always allocates a new row and drops the old
handle — a live row's bits never change (growth reallocs the pool but
copies values verbatim; a view taken earlier still reads the same values
from the old buffer).

Deallocation is tied to **handle lifetime**, not tree bookkeeping: when
the last reference to a ``TreeNode`` handle dies, CPython's refcounting
calls its finalizer, which appends the ``(width, row)`` to the arena's
dead-list; the next allocation drains that list back into the free lists
(append is GIL-atomic, so the finalizer never takes a lock — it may run
at arbitrary points, including inside arena calls).  This is what makes
the concurrent snapshot contract cheap: a cross-tenant ``query_many``
that collected node handles under each store's lock *owns* those rows
until it drops the selection — eviction running concurrently merely
removes dict entries, and the rows cannot be freed (let alone reused and
overwritten) while the in-flight pack still references them.  The
retention race test pins exactly this.

Corollary for callers: hold a strong reference to the handle for as long
as you read its row views.  All in-tree paths do (the rebuild paths keep
the old node dict alive across the rebuild for this reason).

Invalidation vs store version
-----------------------------
The arena deliberately has **no** notion of answer staleness: the store
version (bumped once per mutation batch) keys the LRU answer caches, and
the *plane* version (bumped on every row write) keys only the device
snapshot.  The two move independently — e.g. a cache-invalidating
eviction that frees rows without writing any leaves the device snapshot
valid (freed rows still hold their old bits and are never gathered), so
warm-miss queries keep serving from the resident pools without an
upload.

Footprint metering
------------------
:meth:`allocated_floats` (live rows × padded width) is the *real* arena
footprint a :class:`~repro_torch.core.retention.MemoryBudget` can meter;
``IntervalTree.node_floats`` keeps reporting logical (un-padded) floats
per unique slot so existing budget calibrations are unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.witness import OrderedRLock
from repro_torch.core import failpoints as faults

__all__ = ["NodeArena"]

_MIN_CAPACITY = 64


class _Plane:
    """One ``(capacity, width)`` pool pair for a fixed row width."""

    __slots__ = (
        "width",
        "b",
        "s",
        "free",
        "live",
        "version",
        "_device",
        "_device_version",
    )

    def __init__(self, width: int, capacity: int = _MIN_CAPACITY):
        self.width = int(width)
        self.b = np.zeros((capacity, self.width + 1), np.float32)
        self.s = np.zeros((capacity, self.width), np.float32)
        self.free = list(range(capacity - 1, -1, -1))  # pop() → lowest first
        self.live = 0
        self.version = 0
        self._device = None
        self._device_version = -1

    @property
    def capacity(self) -> int:
        return self.b.shape[0]

    def _grow(self) -> None:
        old = self.capacity
        new = max(_MIN_CAPACITY, old * 2)
        b = np.zeros((new, self.width + 1), np.float32)
        s = np.zeros((new, self.width), np.float32)
        b[:old] = self.b
        s[:old] = self.s
        self.b, self.s = b, s
        self.free.extend(range(new - 1, old - 1, -1))


class NodeArena:
    """Pooled node storage: per-width planes, free lists, device snapshots.

    One arena may back a single tree (the default — every
    :class:`~repro_torch.core.interval_tree.IntervalTree` owns one) or be shared
    by every same-config tenant of a registry
    (``TenantRegistry(shared_arena=True)``), which is what turns the
    cross-tenant merge-stack pack into a single device gather.
    """

    def __init__(self, device: str | torch.device = "cuda"):
        # where :meth:`device` snapshots live; the planes stay host NumPy
        self.torch_device = torch.device(device)
        self._planes: dict[int, _Plane] = {}
        # RLock: public entry points may nest (alloc → reap → free lists)
        self._lock = OrderedRLock("arena._lock")
        # rows whose last handle was garbage-collected; finalizers append
        # without taking the lock (list.append is GIL-atomic), alloc drains
        self._dead: list[tuple[int, int]] = []
        # host-side row materializations since construction/reset — the
        # machine-checked "zero-copy" counter (mirrors merge_dispatches)
        self.host_row_copies = 0

    # ------------------------------------------------------------ allocation
    def _plane(self, width: int) -> _Plane:
        plane = self._planes.get(width)
        if plane is None:
            plane = self._planes[width] = _Plane(width)
        return plane

    def _reap(self) -> None:
        """Drain GC-freed rows back into the free lists (under the lock)."""
        while self._dead:
            width, row = self._dead.pop()
            plane = self._planes.get(width)
            if plane is not None:
                plane.free.append(row)
                plane.live -= 1

    def _pop_slot(self, plane: _Plane) -> int:
        if not plane.free:
            plane._grow()
        plane.live += 1
        return plane.free.pop()

    def alloc(self, width: int, boundaries, sizes) -> int:
        """Write one logical ``(T+1,)``/``(T,)`` summary into a fresh row of
        the ``width`` plane (padded to the plane width with zero-mass copies
        of its last boundary) and return the row index."""
        b = np.asarray(boundaries, np.float32).reshape(-1)
        s = np.asarray(sizes, np.float32).reshape(-1)
        T = s.shape[0]
        if T > width:
            raise ValueError(f"summary of {T} buckets exceeds plane width {width}")
        faults.hit("arena.alloc", width=width)
        with self._lock:
            self._reap()
            plane = self._plane(width)
            row = self._pop_slot(plane)
            plane.b[row, : T + 1] = b
            plane.b[row, T + 1 :] = b[T]
            plane.s[row, :T] = s
            if T < width:
                plane.s[row, T:] = 0.0
            plane.version += 1
            return row

    def alloc_block(self, width: int, boundaries: np.ndarray, sizes: np.ndarray) -> list[int]:
        """Vectorized :meth:`alloc` of ``k`` uniform-width summaries:
        ``boundaries (k, T+1)``, ``sizes (k, T)`` → ``k`` row indices
        (one scatter per pool instead of per row — the merge-output write
        path of the level-batched pull-up)."""
        b = np.asarray(boundaries, np.float32)
        s = np.asarray(sizes, np.float32)
        k, T = s.shape
        if T > width:
            raise ValueError(f"summaries of {T} buckets exceed plane width {width}")
        faults.hit("arena.alloc", width=width, k=k)
        with self._lock:
            self._reap()
            plane = self._plane(width)
            rows = [self._pop_slot(plane) for _ in range(k)]
            idx = np.asarray(rows, np.int64)
            plane.b[idx, : T + 1] = b
            if T < width:
                plane.b[idx, T + 1 :] = b[:, T:]  # (k, 1) broadcasts
                plane.s[idx, T:] = 0.0
            plane.s[idx, :T] = s
            plane.version += 1
            return rows

    # -------------------------------------------------------------- reading
    def view(self, width: int, row: int) -> tuple[np.ndarray, np.ndarray]:
        """Full-width ``(boundaries, sizes)`` views of one row.  Valid for
        as long as the caller holds the row's handle (module docstring)."""
        plane = self._planes[width]
        return plane.b[row], plane.s[row]

    def rows(self, width: int, idx) -> tuple[np.ndarray, np.ndarray]:
        """Materialize many rows host-side with one fancy-index copy per
        pool — the 'one stacked copy per tree' pack path.  Counted in
        :attr:`host_row_copies` (under the lock: the counter is a
        machine-checked benchmark value and the host-pack fallback runs
        outside the store locks)."""
        idx = np.asarray(idx, np.int64)
        faults.hit("arena.rows", width=width)
        with self._lock:
            plane = self._planes[width]
            self.host_row_copies += int(idx.size)
            return plane.b[idx], plane.s[idx]

    def device(self, width: int):
        """Device-resident ``(boundaries, sizes)`` snapshot of the plane on
        the arena's device, rebuilt only when the plane version moved
        since the last call.  The snapshot is a copy (``torch.tensor``),
        so later host-side row writes never alias into it."""
        faults.hit("arena.gather", width=width)
        with self._lock:
            plane = self._planes[width]
            if plane._device_version != plane.version:
                plane._device = (
                    torch.tensor(plane.b, device=self.torch_device),
                    torch.tensor(plane.s, device=self.torch_device),
                )
                plane._device_version = plane.version
            return plane._device

    # ------------------------------------------------------------- metering
    def widths(self) -> list[int]:
        with self._lock:
            return sorted(self._planes)

    def live_rows(self) -> int:
        with self._lock:
            self._reap()
            return sum(p.live for p in self._planes.values())

    def allocated_floats(self) -> int:
        """Real pooled floats held by live rows (padded widths) — the
        figure a memory meter for the *arena itself* acts on."""
        with self._lock:
            self._reap()
            return sum(p.live * (2 * p.width + 1) for p in self._planes.values())

    def capacity_floats(self) -> int:
        """Total pooled floats including free rows (what is resident)."""
        with self._lock:
            return sum(
                p.capacity * (2 * p.width + 1) for p in self._planes.values()
            )

    # ---------------------------------------------------------- persistence
    def export(
        self, slot_refs
    ) -> tuple[dict[str, np.ndarray], dict[tuple[int, int], int]]:
        """Compact the live rows ``slot_refs`` (iterable of ``(width, row)``,
        duplicates allowed) into dense per-plane pools.

        Returns ``(arrays, slot_map)``: ``arrays`` holds ``ab_{width}`` /
        ``as_{width}`` blocks with only the referenced rows (free-list
        fragmentation compacts away on save), ``slot_map`` maps each
        distinct ``(width, row)`` to its dense index — shared handles keep
        sharing one exported row.  One fancy-index copy per plane.
        """
        by_width: dict[int, list[int]] = {}
        slot_map: dict[tuple[int, int], int] = {}
        for width, row in slot_refs:
            key = (width, row)
            if key in slot_map:
                continue
            rows = by_width.setdefault(width, [])
            slot_map[key] = len(rows)
            rows.append(row)
        arrays: dict[str, np.ndarray] = {}
        with self._lock:
            for width, rows in by_width.items():
                plane = self._planes[width]
                idx = np.asarray(rows, np.int64)
                arrays[f"ab_{width}"] = plane.b[idx].copy()
                arrays[f"as_{width}"] = plane.s[idx].copy()
        return arrays, slot_map
