"""Deterministic synthetic data pipeline with histogram length-bucketing.

PyTorch port of ``repro.data.pipeline``.  ``SyntheticLM`` is pure NumPy
and gives the reference's batches bit for bit; ``LengthBucketer.fit`` runs
the port's ``build_exact`` and ``merge_list`` on ``device`` (``None`` →
the card, ``"cpu"`` → the kernels' plain versions); ``shard_batch`` gives
this rank its share of a global batch under the ``Rules``' activation
sharding, on the device.

Determinism contract: ``batch_at(step)`` is a pure function of
``(seed, step)`` — restart-resume needs no data-state checkpoint beyond the
step counter.

Histogram integration (paper → data plane): documents have a skewed length
distribution (log-normal, like real web corpora).  Packing sequences from
unbucketed docs wastes pad tokens; equal-*count* buckets mis-balance token
mass.  We build an **equi-depth histogram of document lengths** — per input
shard, merged with the paper's algorithm — and use its boundaries as length
buckets: every bucket then holds the same number of documents whose lengths
are maximally homogeneous, so pack efficiency is uniform across hosts and
no input-bound straggler emerges.  ``bucket_report()`` quantifies it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.histogram import _host, build_exact, merge_list
from repro_torch.device import as_tensor

__all__ = ["LengthBucketer", "SyntheticLM", "shard_batch"]


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-ish token stream packed into fixed-length training rows."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: float = 350.0
    sigma: float = 1.0
    eos_id: int = 1

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )

    def doc_lengths(self, rng, n: int) -> np.ndarray:
        ln = rng.lognormal(np.log(self.mean_doc_len), self.sigma, size=n)
        return np.clip(ln.astype(np.int64), 8, 4 * self.seq_len)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """(tokens, targets, mask) each (global_batch, seq_len)."""
        rng = self._rng(step)
        B, S = self.global_batch, self.seq_len
        total = B * (S + 1)
        # zipf-ish unigram stream; ids folded into vocab
        raw = rng.zipf(1.3, size=total).astype(np.int64)
        tokens = (raw % (self.vocab_size - 2)) + 2
        # sprinkle EOS at packed-document boundaries
        lens = self.doc_lengths(rng, 4 * total // int(self.mean_doc_len))
        pos = np.cumsum(lens)
        pos = pos[pos < total]
        tokens[pos] = self.eos_id
        grid = tokens.reshape(B, S + 1)
        return {
            "tokens": grid[:, :-1].astype(np.int32),
            "targets": grid[:, 1:].astype(np.int32),
            "mask": np.ones((B, S), np.float32),
        }


@dataclasses.dataclass
class LengthBucketer:
    """Equi-depth document-length buckets from merged shard summaries."""

    num_buckets: int = 8
    summary_T: int = 256
    # where the summaries are built and merged (None → the card)
    device: Any = None

    def fit(self, shard_lengths: list[np.ndarray]):
        """shard_lengths: one array of doc lengths per input shard (host)."""
        summaries = [
            build_exact(
                s.astype(np.float32),
                min(self.summary_T, len(s)),
                device=self.device,
            )
            for s in shard_lengths
        ]
        merged = merge_list(summaries, self.num_buckets)
        self.boundaries_ = _host(merged.boundaries)
        self.merged_ = merged
        return self

    def assign(self, lengths: np.ndarray) -> np.ndarray:
        return np.clip(
            np.searchsorted(self.boundaries_[1:-1], lengths, side="right"),
            0,
            self.num_buckets - 1,
        )

    def bucket_report(self, lengths: np.ndarray) -> dict:
        """Pack-efficiency: pad waste with vs. without bucketing."""
        b = self.assign(lengths)
        waste_bucketed, waste_flat = 0.0, 0.0
        for i in range(self.num_buckets):
            sel = lengths[b == i]
            if len(sel) == 0:
                continue
            waste_bucketed += float(np.sum(sel.max() - sel))
        waste_flat = float(np.sum(lengths.max() - lengths))
        tot = float(lengths.sum())
        return {
            "pad_waste_bucketed": waste_bucketed / (tot + waste_bucketed),
            "pad_waste_unbucketed": waste_flat / (tot + waste_flat),
            "counts": np.bincount(b, minlength=self.num_buckets).tolist(),
        }


def shard_batch(batch: dict, rules=None, mesh=None, device=None) -> dict:
    """This rank's share of a global batch, as tensors on ``device``
    (``None`` → the card).

    The reference ``device_put``s the whole batch with the ``Rules``'
    activation sharding (``("act_batch", None)``, or ``("act_batch", None,
    None)`` for 3-D leaves): the leading dimension splits into equal blocks
    over the ``act_batch`` mesh axes, taken in row-major order of this
    rank's coordinates on them.  Without a mesh, or with ``act_batch``
    replicated, every rank gets the whole batch."""
    axes = () if rules is None or mesh is None else rules.batch_axes()
    k, idx = 1, 0
    for ax in axes:
        size = mesh.size(mesh.mesh_dim_names.index(ax))
        idx, k = idx * size + mesh.get_local_rank(ax), k * size
    out = {}
    for key, v in batch.items():
        if v.shape[0] % k:
            raise ValueError(f"batch {key!r} of {v.shape[0]} rows does not split over {k} ranks")
        n = v.shape[0] // k
        out[key] = as_tensor(v[idx * n:(idx + 1) * n], device)
    return out
