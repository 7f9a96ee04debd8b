"""The inputs of a run, made on the device from the seed.

A configuration's ``distribution`` names a value generator here
(:data:`GENERATORS`), and its ``values_per_partition`` is either one
number, every partition's length, or a length generator by name
(:data:`LENGTHS`).  The lengths are drawn on the host from the seed, the
values on the card with one ``torch.Generator`` seeded from ``--seed``, in
float32, and copied to one host buffer: the program is handed host
arrays, as a Summarizer job reads a day of logs.
"""
from __future__ import annotations

import numpy as np
import torch

_DRAW = 1 << 28  # values drawn on the card at once (1 GiB)


def _gumbel(x: torch.Tensor, g: torch.Generator, loc: float, scale: float) -> None:
    # Gumbel(loc, scale) = loc - scale·log(E), E ~ Exp(1); the paper's skewed set
    x.exponential_(generator=g).clamp_(min=torch.finfo(torch.float32).tiny)
    x.log_().mul_(-scale).add_(loc)


def _lognormal(x: torch.Tensor, g: torch.Generator, mu: float, sigma: float) -> None:
    # exp(sigma·N(0, 1) + mu): request latencies
    x.normal_(generator=g).mul_(sigma).add_(mu).exp_()


GENERATORS = {"gumbel": _gumbel, "lognormal": _lognormal}


def _lognormal_lengths(rng: np.random.Generator, shape, median: float, sigma: float, min: int, max: int):
    # ragged partitions: lengths log-normal about ``median``, clipped
    n = np.exp(np.log(median) + sigma * rng.standard_normal(shape))
    return np.clip(np.rint(n), min, max).astype(np.int64)


LENGTHS = {"lognormal": _lognormal_lengths}


class Pool:
    """Partition ``p`` of tenant ``t`` (``values[offsets[t, p]:offsets[t, p] + lengths[t, p]]``)
    of the ``(tenants, parts)`` partitions a run draws; partition id ``d``
    of a tenant replays pool partition ``d % parts``."""

    def __init__(self, values: np.ndarray, lengths: np.ndarray):
        self.values, self.lengths = values, lengths
        self.tenants, self.parts = lengths.shape
        self.offsets = np.concatenate([[0], np.cumsum(lengths.reshape(-1))])[:-1].reshape(lengths.shape)

    def part(self, t: int, d: int) -> np.ndarray:
        p = d % self.parts
        at = int(self.offsets[t, p])
        return self.values[at : at + int(self.lengths[t, p])]

    def n(self, t: int, d: int) -> int:
        return int(self.lengths[t, d % self.parts])


def lengths_of(cfg: dict, seed: int) -> np.ndarray:
    """``(tenants, pool_partitions)`` partition lengths of a run."""
    shape = (int(cfg["tenants"]), int(cfg["pool_partitions"]))
    n = cfg["values_per_partition"]
    if not isinstance(n, dict):
        return np.full(shape, int(n), np.int64)
    kw = dict(n)
    return LENGTHS[kw.pop("kind")](np.random.default_rng([int(seed), 0x1E6]), shape, **kw)


def make_pool(cfg: dict, seed: int, device) -> Pool:
    """The host pool of a run: every partition drawn on ``device``, in
    groups of whole partitions of at most ``_DRAW`` values."""
    dist = dict(cfg["distribution"])
    fill = GENERATORS[dist.pop("kind")]
    lengths = lengths_of(cfg, seed)
    flat = lengths.reshape(-1)
    values = np.empty(int(flat.sum()), np.float32)
    host = torch.from_numpy(values)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    buf = torch.empty(max(_DRAW, int(flat.max())), dtype=torch.float32, device=device)
    at, i = 0, 0
    while i < flat.size:
        j, size = i + 1, int(flat[i])
        while j < flat.size and size + flat[j] <= _DRAW:
            size += int(flat[j])
            j += 1
        fill(buf[:size], g, **dist)
        host[at : at + size].copy_(buf[:size])
        at, i = at + size, j
    del buf
    return Pool(values, lengths)
