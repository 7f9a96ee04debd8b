"""What a correct run must give, worked out again from the raw pool.

The reference sorts every partition of the pool itself and takes:

- each partition's exact ``T``-bucket equi-depth summary: the sorted
  values at the cuts ``min(floor(i·n/T), n - 1)``, sizes the differences
  of ``floor(i·n/T)`` (the paper's Summarizer);
- the true count of each bucket of an answer over ``[lo, hi]``: bucket
  i holds ``[b_i, b_{i+1})``, the last one ``b_beta`` too;
- the paper's error bound of the interval tree's answer (Theorem 1,
  composed per level: a leaf 0, a node ``eps_l + eps_r + 2n/T + 4``, an
  answer ``sum eps_v + 2N/T + 2|v|``), the largest over every alignment
  of the window on the tree's slots, so that it needs none of the
  program's state.

It judges three numbers, each against the limit that the cell's file
under ``limits/`` gives it: summaries that differ from the exact ones in
any entry (and partitions missing or extra), answer boundaries that are no boundary of an exact summary inside the window
(every boundary a merge gives is one of its inputs'), and the widest gap
of a bucket's true or reported count from ``N/beta``, over the smaller of
the reported bound and the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

_SORT_BLOCK = 1 << 27  # values sorted at once
_ANSWER_BLOCK = 2048  # answers judged at once


def cuts(n: int, T: int) -> np.ndarray:
    """``floor(i·n/T)`` for ``i = 0..T``, in exact integers."""
    i = np.arange(T + 1, dtype=np.int64)
    return i * (n // T) + (i * (n % T)) // T


def tree_eps_bound(n_leaves: list[int], T: int) -> float:
    """The largest composed bound of a window of leaves holding
    ``n_leaves`` values each, over every alignment of its first leaf."""
    w = len(n_leaves)
    prefix = np.concatenate([[0], np.cumsum(n_leaves, dtype=np.float64)])
    best = 0.0
    for a in range(64):
        memo: dict[tuple[int, int], float] = {}

        def node_eps(level: int, idx: int) -> float:
            if level == 0:
                return 0.0
            key = (level, idx)
            if key not in memo:
                lo = idx << level
                n = prefix[lo + (1 << level) - a] - prefix[lo - a]
                memo[key] = node_eps(level - 1, 2 * idx) + node_eps(level - 1, 2 * idx + 1) + 2.0 * n / T + 4.0
            return memo[key]

        total, count, l, r, level = 0.0, 0, a, a + w, 0
        while l < r:
            if l & 1:
                total += node_eps(level, l)
                count += 1
                l += 1
            if r & 1:
                r -= 1
                total += node_eps(level, r)
                count += 1
            l >>= 1
            r >>= 1
            level += 1
        best = max(best, total + 2.0 * prefix[-1] / T + 2.0 * count)
    return best


class Reference:
    """The sorted pool and its exact summaries, on ``device``; partition
    id ``d`` of a tenant is pool partition ``d % parts`` (``data.Pool``)."""

    def __init__(self, pool, T: int, device):
        lengths = pool.lengths.reshape(-1)
        if lengths.min() < T:
            raise ValueError("the reference takes partitions of at least T values")
        self.T, self.P, self.pool = T, pool.parts, pool
        self.sorted = torch.empty(int(lengths.sum()), dtype=torch.float32, device=device)
        leaf_b = torch.empty((lengths.size, T + 1), dtype=torch.float32, device=device)
        leaf_s = np.empty((lengths.size, T), np.float64)
        src, offsets = torch.from_numpy(pool.values), pool.offsets.reshape(-1)
        i = 0
        while i < lengths.size:  # runs of partitions of one length, sorted together
            n, j = int(lengths[i]), i + 1
            while j < lengths.size and j - i < max(1, _SORT_BLOCK // n) and lengths[j] == n:
                j += 1
            a = int(offsets[i])
            block = src[a : a + n * (j - i)].to(device).reshape(j - i, n)
            srt = torch.sort(block, dim=-1).values
            del block
            self.sorted[a : a + n * (j - i)] = srt.reshape(-1)
            c = cuts(n, T)
            leaf_b[i:j] = srt[:, torch.from_numpy(np.minimum(c, n - 1)).to(device)]
            leaf_s[i:j] = np.diff(c)
            del srt
            i = j
        self.leaf_b = leaf_b.reshape(pool.tenants, self.P, T + 1)
        self.leaf_s = leaf_s.reshape(pool.tenants, self.P, T)
        self._leaf_b_host = self.leaf_b.cpu().numpy()
        self._bound: dict[tuple, float] = {}

    def _sorted(self, t: int, p: int) -> torch.Tensor:
        at = int(self.pool.offsets[t, p])
        return self.sorted[at : at + int(self.pool.lengths[t, p])]

    def summary_mismatches(self, items) -> int:
        """Entries of ``(tenant, pid, boundaries, sizes)`` that differ from
        the exact summary of the partition."""
        bad = 0
        for t, pid, b, s in items:
            want_b, want_s = self._leaf_b_host[t, pid % self.P], self.leaf_s[t, pid % self.P]
            b = np.asarray(b, np.float32).reshape(-1)
            s = np.asarray(s, np.float64).reshape(-1)
            if b.shape != want_b.shape or s.shape != want_s.shape:
                bad += want_b.shape[0] + want_s.shape[0]
                continue
            bad += int(np.count_nonzero(b != want_b)) + int(np.count_nonzero(s != want_s))
        return bad

    def retained_mismatches(self, t: int, want_ids, got: dict) -> int:
        """:meth:`summary_mismatches` of a tenant's retained partitions, each
        missing or extra partition counted as a whole summary."""
        want_ids = set(int(p) for p in want_ids)
        whole = 2 * self.T + 1
        bad = whole * len(want_ids ^ set(got))
        items = [(t, pid, *got[pid]) for pid in sorted(want_ids & set(got))]
        return bad + self.summary_mismatches(items)

    def eps_bound(self, t: int, lo: int, hi: int) -> float:
        ns = tuple(self.pool.n(t, d) for d in range(lo, hi + 1))
        if ns not in self._bound:
            self._bound[ns] = tree_eps_bound(list(ns), self.T)
        return self._bound[ns]

    def judge_answers(self, answers) -> tuple[int, float]:
        """``(boundaries_off_leaves, bucket_err_over_eps)`` of answers
        ``(tenant, lo, hi, beta, boundaries, sizes, eps)``."""
        off, worst = 0, 0.0
        groups: dict[tuple[int, int], list] = {}
        for a in answers:
            groups.setdefault((int(a[0]), int(a[3])), []).append(a)
        dev = self.sorted.device
        for (t, beta), rows in groups.items():
            for at in range(0, len(rows), _ANSWER_BLOCK):
                block = rows[at : at + _ANSWER_BLOCK]
                A = len(block)
                B = torch.from_numpy(np.stack([np.asarray(r[4], np.float32) for r in block])).to(dev)
                if B.shape[1] != beta + 1:
                    raise ValueError("an answer has the wrong number of boundaries")
                mult = np.zeros((A, self.P), np.int64)
                for i, r in enumerate(block):
                    days = np.arange(int(r[1]), int(r[2]) + 1)
                    mult[i] = np.bincount(days % self.P, minlength=self.P)
                m = torch.from_numpy(mult).to(dev)
                V = B.reshape(-1)
                below = torch.zeros((A, beta + 1), dtype=torch.int64, device=dev)
                eq_last = torch.zeros(A, dtype=torch.int64, device=dev)
                for p in map(int, np.flatnonzero(mult.any(0))):
                    st = self._sorted(t, p)
                    lt = torch.searchsorted(st, V).reshape(A, beta + 1)
                    le_last = torch.searchsorted(st, B[:, -1].contiguous(), right=True)
                    below += m[:, p, None] * lt
                    eq_last += m[:, p] * (le_last - lt[:, -1])
                true = (below[:, 1:] - below[:, :-1]).cpu().numpy().astype(np.float64)
                true[:, -1] += eq_last.cpu().numpy()
                L = self.leaf_b[t]  # (P, T+1), ascending
                VV = V.reshape(1, -1).expand(self.P, -1).contiguous()
                idx = torch.searchsorted(L, VV).clamp_(max=self.T)
                hit = (L.gather(1, idx) == VV).reshape(self.P, A, beta + 1)
                found = ((m.t()[:, :, None] > 0) & hit).any(0).cpu().numpy()
                off += int(np.count_nonzero(~found))
                N = mult @ self.pool.lengths[t].astype(np.int64)
                for i, r in enumerate(block):
                    rep = np.asarray(r[5], np.float64)
                    err = max(np.abs(true[i] - N[i] / beta).max(), np.abs(rep - N[i] / beta).max())
                    eps = min(float(r[6]), self.eps_bound(t, int(r[1]), int(r[2])))
                    worst = max(worst, err / eps if eps > 0 else float("inf"))
        return off, float(worst)
