"""A ``repro_torch`` ``TenantRegistry`` of named tenants on one shared
arena: many small stores behind one merge dispatch a batch.  Tenant ``t``
is named ``t%03d``.  Ingest mode: ``async`` (``ingest_async`` of every
tenant, then ``flush``).  The interface is the one ``systems/__init__.py``
states."""
from __future__ import annotations

from hbench.systems import program_counters
from repro_torch.core import SlidingWindow, TenantRegistry


class System:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.names = [f"t{t:03d}" for t in range(int(cfg["tenants"]))]
        self.reg = TenantRegistry(
            num_buckets=int(cfg["num_buckets"]),
            shared_arena=True,
            retention=SlidingWindow(int(cfg["retention_partitions"])),
            device=device,
        )

    def warm(self, pool, traffic: dict) -> None:
        """A month of one tenant through the async path, every window of
        it in one batch, and one more day to evict under retention."""
        days, beta = int(self.cfg["retention_partitions"]), int(traffic["beta"])
        warm = System({**self.cfg, "tenants": 1}, self.reg.device)
        for d in range(days + 1):
            warm.reg.ingest_async(warm.names[0], d, pool.part(0, d))
            if d == days - 1 or d == days:
                warm.reg.flush()
                warm.reg.query_many([(warm.names[0], lo, d) for lo in range(d - days + 1, d + 1)], beta)
        warm.close()

    def ingest(self, pid: int, parts, mode: str):
        if mode != "async":
            raise ValueError(f"a registry ingests async, not {mode!r}")
        for t, values in enumerate(parts):
            self.reg.ingest_async(self.names[t], pid, values)
        self.reg.flush()
        return []

    def query_many(self, reqs, beta: int):
        out = self.reg.query_many([(self.names[t], lo, hi) for t, lo, hi in reqs], beta)
        return [(h.boundaries, h.sizes, eps) for h, eps in out]

    def retained(self, t: int) -> dict:
        store = self.reg[self.names[t]]
        return {p: (s.boundaries, s.sizes) for p, s in store.summaries.items()}

    def counters(self) -> dict:
        return program_counters(self.reg.cache_stats())

    def close(self) -> None:
        self.reg.close()
