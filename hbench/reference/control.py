"""The control: the reference put in the program's place, one precision
down.  The configurations state float32 values; the control rounds every
value to bfloat16 before it summarizes, then merges a window's exact
summaries flat (the paper's Algorithm 1, rank-select form) and reports the
paper's flat bound ``2N/T + 2k``.  A sound judge must find it not correct.
"""
from __future__ import annotations

import numpy as np
import torch

from hbench.reference.exact import cuts


def merge_flat(bounds: torch.Tensor, sizes: torch.Tensor, beta: int):
    """Merge ``k`` summaries ``(k, T+1)``/``(k, T)`` into ``beta`` buckets."""
    k = bounds.shape[0]
    mass = torch.cat([sizes, torch.zeros((k, 1), dtype=sizes.dtype, device=sizes.device)], dim=1).reshape(-1)
    flat = bounds.reshape(-1)
    order = torch.argsort(flat, stable=True)
    pos = flat[order]
    A = torch.cumsum(mass[order], dim=0)[:-1]
    n = sizes.sum()
    targets = torch.arange(1, beta, dtype=A.dtype, device=A.device) * (n / beta)
    cut = torch.searchsorted(A, targets, right=True)
    b = torch.cat([pos[:1], pos[cut], pos[-1:]])
    prev = torch.where(cut > 0, A[(cut - 1).clamp(min=0)], torch.zeros_like(targets))
    s = torch.diff(torch.cat([n.reshape(1) * 0, prev, n.reshape(1)]))
    return b, s


class System:
    def __init__(self, cfg: dict, device):
        self.T = int(cfg["num_buckets"])
        self.keep = int(cfg["retention_partitions"])
        self.device = torch.device(device)
        self.leaves: list[dict[int, tuple[np.ndarray, np.ndarray]]] = [{} for _ in range(cfg["tenants"])]

    def warm(self, pool, traffic: dict) -> None:
        pass

    def _summary(self, values: np.ndarray):
        x = torch.from_numpy(values).to(self.device).to(torch.bfloat16).to(torch.float32)
        v = torch.sort(x).values
        n = v.shape[0]
        c = cuts(n, self.T)
        b = v[torch.from_numpy(np.minimum(c, n - 1)).to(self.device)].cpu().numpy()
        return b, np.diff(c).astype(np.float32)

    def ingest(self, pid: int, parts, mode: str):
        out = []
        for t, values in enumerate(parts):
            b, s = self._summary(values)
            leaves = self.leaves[t]
            leaves[int(pid)] = (b, s)
            for old in sorted(leaves)[: max(0, len(leaves) - self.keep)]:
                del leaves[old]
            out.append((t, int(pid), b, s))
        return out if mode == "sync" else []

    def query(self, t: int, lo: int, hi: int, beta: int):
        rows = [self.leaves[t][d] for d in range(lo, hi + 1)]
        bounds = torch.from_numpy(np.stack([r[0] for r in rows])).to(self.device)
        sizes = torch.from_numpy(np.stack([r[1] for r in rows]).astype(np.float64)).to(self.device)
        b, s = merge_flat(bounds, sizes, beta)
        N = float(sizes.sum())
        return b.cpu().numpy(), s.cpu().numpy(), 2.0 * N / self.T + 2.0 * len(rows)

    def query_many(self, reqs, beta: int):
        return [self.query(t, lo, hi, beta) for t, lo, hi in reqs]

    def retained(self, t: int) -> dict:
        return dict(self.leaves[t])

    def counters(self) -> dict:
        return {"tile_sort": 0, "merge_cut": 0, "cache_hits": 0, "cache_misses": 0}

    def close(self) -> None:
        self.leaves = []
