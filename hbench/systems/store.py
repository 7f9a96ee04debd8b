"""One ``repro_torch`` ``HistogramStore``: the paper's Summarizer and Merger.

Ingest modes: ``sync`` (``HistogramStore.ingest``, the summary handed
back) and ``summary`` (the program's exact Summarizer on a device copy,
its summary stored as it is: a set-up path for cells that measure the
Merger alone).  The interface is the one ``systems/__init__.py`` states.
"""
from __future__ import annotations

import torch

from hbench.systems import program_counters
from repro_torch.core import HistogramStore, SlidingWindow, build_exact


class System:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.store = HistogramStore(
            num_buckets=int(cfg["num_buckets"]),
            retention=SlidingWindow(int(cfg["retention_partitions"])),
            device=device,
        )

    def warm(self, pool, traffic: dict) -> None:
        """One real ingest (the row sort), then copies of its summary as
        a month of partitions and every window of it: the tree's pull-ups
        and both merge regimes."""
        days, beta = int(self.cfg["retention_partitions"]), int(traffic["beta"])
        warm = System(self.cfg, self.store.device)
        summ = warm.store.ingest(0, pool.part(0, 0))
        for d in range(1, days):
            warm.store.ingest_summary(d, summ.to_histogram("cpu"))
        for hi in range(days):
            warm.store.query(0, hi, beta)
        warm.store.query_many([(lo, days - 1) for lo in range(days)], beta)
        warm.close()

    def ingest(self, pid: int, parts, mode: str):
        (values,) = parts
        if mode == "summary":
            h = build_exact(torch.from_numpy(values).to(self.store.device), self.store.num_buckets)
            self.store.ingest_summary(pid, h)
            return []
        if mode != "sync":
            raise ValueError(f"a store ingests sync or summary, not {mode!r}")
        s = self.store.ingest(pid, values)
        return [(0, int(pid), s.boundaries, s.sizes)]

    def query(self, t: int, lo: int, hi: int, beta: int):
        h, eps = self.store.query(lo, hi, beta)
        return h.boundaries, h.sizes, eps

    def query_many(self, reqs, beta: int):
        out = self.store.query_many([(lo, hi) for _, lo, hi in reqs], beta)
        return [(h.boundaries, h.sizes, eps) for h, eps in out]

    def retained(self, t: int) -> dict:
        return {p: (s.boundaries, s.sizes) for p, s in self.store.summaries.items()}

    def counters(self) -> dict:
        tree = self.store._tree
        return program_counters(self.store.cache_stats(), merge_dispatches=tree.merge_dispatches,
                                host_row_copies=tree.arena.host_row_copies)

    def close(self) -> None:
        self.store.close()
