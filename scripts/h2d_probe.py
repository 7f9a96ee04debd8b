"""Host-to-device upload of one Summarizer day on this host's card: what
the pinned staging ring of ``core/pinned.py`` is sized from.

    PYTHONPATH=src python scripts/h2d_probe.py [--values 161290322] [--reps 5]

Times, for one float32 row of ``--values`` values in pageable host memory
(the caller's array, as ``HistogramStore.ingest`` receives it):

  (a) ``copy_`` of the pageable row into a device buffer, as ingest did;
  (b) ``copy_`` of the same bytes from pinned memory alone, whole and in
      chunks;
  (c) ``np.copyto`` of the row into pinned memory with 1, 2, 4 and 8
      threads, into one row-sized buffer and into reused chunk slots;
  (d) the store's pinned staging ring (``repro_torch.core.pinned``) over
      thread counts and chunk sizes (a fresh ring each, its constants set
      before it is built); then the direct copy and the ring as the store
      builds it over row sizes, for the crossover.

Each figure is the median of ``--reps`` host-clock times of work that ends
in a synchronize.  Prints one JSON line a measurement, after one with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import pinned

MiB = 1 << 20


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def timed(fn, reps: int) -> float:
    """Median seconds of ``fn()`` followed by a device synchronize."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def threaded_copy(pool: ThreadPoolExecutor, threads: int, dst: np.ndarray, src: np.ndarray) -> None:
    cut = np.linspace(0, src.size, threads + 1).astype(np.int64)
    for f in [pool.submit(np.copyto, dst[a:b], src[a:b]) for a, b in zip(cut[:-1], cut[1:])]:
        f.result()


def ring_upload(dst: torch.Tensor, src: np.ndarray) -> None:
    with pinned.Upload() as up:
        up.copy(dst, src)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--values", type=int, default=161_290_322)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    torch.set_num_threads(1)  # as hbench/run.py runs the program
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    emit(card=card, cpus=len(os.sched_getaffinity(0)), torch=torch.__version__)
    n, reps = args.values, args.reps
    src32 = np.arange(n, dtype=np.float32)  # pageable, every page touched
    src = src32.view(np.uint8)
    nb = src.nbytes
    dev = torch.empty(nb, dtype=torch.uint8, device="cuda")
    gbs = lambda s: nb / s / 1e9  # noqa: E731

    s = timed(lambda: dev.copy_(torch.from_numpy(src)), reps)
    emit(step="a_pageable_copy", bytes=nb, ms=s * 1e3, gb_s=gbs(s))

    host = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = src
    s = timed(lambda: dev.copy_(host, non_blocking=True), reps)
    emit(step="b_pinned_copy", bytes=nb, ms=s * 1e3, gb_s=gbs(s))
    for c in (2, 8, 32):
        def chunked(c=c * MiB):
            for a in range(0, nb, c):
                dev[a : a + c].copy_(host[a : a + c], non_blocking=True)
        s = timed(chunked, reps)
        emit(step="b_pinned_copy_chunked", chunk_mib=c, ms=s * 1e3, gb_s=gbs(s))

    pn = host.numpy()
    for threads in (1, 2, 4, 8):
        with ThreadPoolExecutor(threads) as pool:
            s = timed(lambda: threaded_copy(pool, threads, pn, src), reps)
            emit(step="c_copyto_pinned_row", threads=threads, ms=s * 1e3, gb_s=gbs(s))
            for c in (8, 32):
                slots = [torch.empty(c * MiB, dtype=torch.uint8, pin_memory=True).numpy() for _ in range(threads)]

                def into_slots(c=c * MiB, slots=slots):
                    def work(t):
                        for a in range(t * c, nb, threads * c):
                            b = min(a + c, nb)
                            np.copyto(slots[t][: b - a], src[a:b])
                    for f in [pool.submit(work, t) for t in range(threads)]:
                        f.result()
                s = timed(into_slots, reps)
                emit(step="c_copyto_pinned_slots", threads=threads, chunk_mib=c, ms=s * 1e3, gb_s=gbs(s))
    del host, pn

    built = pinned.THREADS, pinned.CHUNK_BYTES
    for threads in (4, 5, 6, 7, 8):
        for c in (32, 64, 128):
            pinned.THREADS, pinned.CHUNK_BYTES, pinned._RINGS = threads, c * MiB, {}
            ring_upload(dev, src)  # warm: the slots, events and threads
            s = timed(lambda: ring_upload(dev, src), reps)
            ok = torch.equal(dev[:: 1 << 16].cpu(), torch.from_numpy(src[:: 1 << 16].copy()))
            emit(step="d_ring", threads=threads, chunk_mib=c, ms=s * 1e3, gb_s=gbs(s), equal=ok)

    # crossover: a row of `size` bytes at rotating offsets of the source
    (pinned.THREADS, pinned.CHUNK_BYTES), pinned._RINGS, pinned.MIN_BYTES = built, {}, 0
    ring_upload(dev, src)
    for size in (8 * MiB, 16 * MiB, 32 * MiB, 48 * MiB, 64 * MiB, 96 * MiB, 128 * MiB):
        offs = [(i * 7919 * 4096) % (nb - size) for i in range(max(reps, 20))]
        it = iter(offs * 4)
        direct = timed(lambda: (lambda a: dev[:size].copy_(torch.from_numpy(src[a : a + size])))(next(it)),
                       len(offs))
        ring = timed(lambda: (lambda a: ring_upload(dev[:size], src[a : a + size]))(next(it)), len(offs))
        emit(step="d_crossover", threads=built[0], chunk_mib=built[1] // MiB, bytes=size,
             direct_ms=direct * 1e3, ring_ms=ring * 1e3)


if __name__ == "__main__":
    main()
