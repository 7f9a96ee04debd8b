"""The Summarizer's upload: host arrays into rows of the sort's device buffer.

A row of :data:`MIN_BYTES` or more bound for a CUDA device goes through
that device's pinned staging ring: its bytes are cut into chunks of
:data:`CHUNK_BYTES` (:func:`chunks`), and :data:`THREADS` copy threads each
take the next chunk, wait until a free page-locked slot's last DMA is done,
copy the chunk into the slot (``np.copyto`` drops the interpreter lock) and
start the slot's DMA on the ring's copy stream.  The host copies of one
chunk so overlap the DMAs of others, where a copy from pageable memory is
staged by the CUDA runtime on one thread before its DMA.  A smaller row, and
every row bound for the CPU, is one direct ``copy_``: a small copy is
latency-bound, and the ring would add a hand-off to the threads and a
stream wait.

One ring serves every store of the process on its device, one batch at a
time (a lock held for the batch's upload): the slots are host memory
locked for the life of the process, so they are built once, at the first
large upload to the device, and never per store or per call.

Ordering: the copy stream waits for the caller's current stream (the
buffer's sentinel fill) before the batch's first DMA, and the caller's
current stream waits for the copy stream when the batch ends (before the
duplicated rows are copied and the sort runs).  :meth:`Upload.copy`
returns once every byte of the caller's array has been copied out of it;
no reference to it is kept.
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from repro_torch.core import spans

__all__ = ["CHUNK_BYTES", "MIN_BYTES", "THREADS", "Upload", "chunks", "host_tensor"]

# Measured on the card host (H100 80GB HBM3, PCIe Gen5, 8 cores;
# ``scripts/h2d_probe.py`` and whole ingests, PERF.md section 6),
# one 645 MB float32 day: the pageable ``copy_`` 103-148 ms, a pinned
# ``copy_`` alone 14 ms (45.8 GB/s), ``np.copyto`` into pinned memory
# 7.2 GB/s on one thread and 13.6 / 20.3 GB/s on four / eight; so the host
# copies, not the DMA, bound the ring, and no thread count keeps the DMA
# busy.  64 MiB chunks beat 32 MiB ones at every thread count, and 128 MiB
# ones gain nothing.  The upload (``store.h2d``) at 64 MiB took 29.3-30.2
# ms on four threads, 26.6-29.1 on five, 23.4-30.5 on six and 22.7-23.6 on
# seven: six is the smallest count on the plateau.  Two spare slots keep a
# thread from waiting on a DMA queued behind the others'.
CHUNK_BYTES = 64 << 20
THREADS = 6
# the crossover: the ring 14.5 ms against the direct copy's 17.3 ms at
# 64 MiB, 16.1 against 9.9 at 48 MiB (one chunk, one thread)
MIN_BYTES = 64 << 20


def chunks(nbytes: int, chunk: int) -> list[tuple[int, int]]:
    """``[a, b)`` byte ranges of ``chunk`` bytes (the last one shorter)
    that cover ``[0, nbytes)`` once, in order."""
    return [(a, min(a + chunk, nbytes)) for a in range(0, nbytes, chunk)]


def host_tensor(v: np.ndarray) -> torch.Tensor:
    """A tensor over a contiguous host array that is only read from.  A
    read-only array is taken through a writable alias of its bytes: torch
    warns about read-only memory, and a copy out of it writes nothing
    there.  The caller keeps ``v`` alive while the tensor is used."""
    if not v.flags.writeable:
        alias = (ctypes.c_char * v.nbytes).from_address(v.ctypes.data)
        v = np.frombuffer(alias, dtype=v.dtype)
    return torch.from_numpy(v)


class _Ring:
    """A device's copy stream, page-locked slots with one event each, a
    queue of the free slots, and the copy threads."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()  # held for one batch's upload
        self.threads = min(THREADS, len(os.sched_getaffinity(0)))
        self.chunk = CHUNK_BYTES
        self.stream = torch.cuda.Stream(device)
        n = self.threads + 2
        self._slots = [torch.empty(self.chunk, dtype=torch.uint8, pin_memory=True) for _ in range(n)]
        self._host = [s.numpy() for s in self._slots]
        self._events = [torch.cuda.Event() for _ in range(n)]
        self._free: queue.SimpleQueue[int] = queue.SimpleQueue()
        for i in range(n):
            self._free.put(i)
        self._pool = ThreadPoolExecutor(self.threads, thread_name_prefix="pinned-upload")

    def copy(self, dst: torch.Tensor, v: np.ndarray) -> None:
        """``dst.copy_(v)`` through the slots; returns when every chunk has
        left ``v`` (its DMA may still run on the copy stream)."""
        src = v.reshape(-1).view(np.uint8)
        out = dst.view(torch.uint8)
        todo: queue.SimpleQueue[tuple[int, int]] = queue.SimpleQueue()
        plan = chunks(src.nbytes, self.chunk)
        for c in plan:
            todo.put(c)
        futures = [self._pool.submit(self._work, todo, out, src) for _ in range(min(self.threads, len(plan)))]
        wait(futures)  # every thread done with ``v`` before any error is raised
        for f in futures:
            f.result()

    def _work(self, todo: queue.SimpleQueue, out: torch.Tensor, src: np.ndarray) -> None:
        # a stream is current per thread: this one names the copy stream
        with torch.cuda.stream(self.stream):
            while True:
                try:
                    a, b = todo.get_nowait()
                except queue.Empty:
                    return
                i = self._free.get()
                try:
                    self._events[i].synchronize()  # the slot's last DMA is done
                    np.copyto(self._host[i][: b - a], src[a:b])
                    out[a:b].copy_(self._slots[i][: b - a], non_blocking=True)
                finally:
                    self._events[i].record(self.stream)
                    self._free.put(i)


_RINGS: dict[torch.device, _Ring] = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = _Ring(device)
        return ring


class Upload:
    """One batch's copies of host arrays into rows of a device buffer
    (``with Upload() as up: up.copy(x[r, :n], v)``): large rows bound for a
    CUDA device through its ring (counted in ``ingest.pinned_bytes``), the
    others by a direct ``copy_``.  The ring is held from the batch's first
    large row to the end of the ``with``."""

    def __init__(self):
        self._ring: _Ring | None = None

    def __enter__(self) -> "Upload":
        return self

    def copy(self, dst: torch.Tensor, v: np.ndarray) -> None:
        """``dst.copy_(v)`` for a contiguous 1-D ``v`` of ``dst``'s dtype."""
        if dst.device.type != "cuda" or v.nbytes < MIN_BYTES:
            dst.copy_(host_tensor(v))
            return
        if self._ring is None:
            ring = _ring(dst.device)
            ring.lock.acquire()
            self._ring = ring
            ring.stream.wait_stream(torch.cuda.current_stream(dst.device))  # after the fill
        self._ring.copy(dst, v)
        spans.count("ingest.pinned_bytes", v.nbytes)

    def __exit__(self, *exc) -> bool:
        ring, self._ring = self._ring, None
        if ring is not None:
            try:  # the duplicated rows and the sort after every DMA
                torch.cuda.current_stream(ring.device).wait_stream(ring.stream)
            finally:
                ring.lock.release()
        return False
