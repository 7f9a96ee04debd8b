"""Quickstart: the paper's §4 worked example + the quality guarantee.

Port of ``examples/quickstart.py``.  Reproduces the exact numbers from the
paper:
  P1 = {2,4,5,6,7,10,13,16,18,20,21,25}   → H1 = {(2,4),(7,4),(18,4),(25,0)}
  P2 = {3,9,...,30}                        → H2 = {(3,5),(15,5),(24,5),(30,0)}
  merge(H1, H2, β=3)                       → H* = {(2,9),(7,9),(18,9),(30,0)}

then demonstrates the ε_max < 2β/T·(N/β) guarantee on a million-value
Gumbel stream and the paper's T ≥ 40β rule for ≤5 % bucket error, and
holds the merged histogram's true occupancy (the bucket count) to it.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    build_exact,
    merge_list,
    merge_histograms_sequential,
    quantile,
    theoretical_eps_max,
)
from repro_torch.kernels import bucket_sizes

CLOCK_FIELDS, MODEL_FIELDS = (), ()  # every number repeats bit for bit


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def main(device=None) -> None:
    # --- the worked example -------------------------------------------------
    P1 = np.asarray([2, 4, 5, 6, 7, 10, 13, 16, 18, 20, 21, 25], np.float32)
    P2 = np.asarray(
        [3, 9, 11, 12, 14, 15, 17, 19, 22, 23, 24, 26, 27, 29, 30], np.float32
    )
    H1, H2 = build_exact(P1, 3, device=device), build_exact(P2, 3, device=device)
    print("H1:", list(zip(_host(H1.boundaries), np.r_[_host(H1.sizes), 0])))
    print("H2:", list(zip(_host(H2.boundaries), np.r_[_host(H2.sizes), 0])))
    Hs = merge_list([H1, H2], 3)
    print("H* (vectorized):", _host(Hs.boundaries), _host(Hs.sizes))
    Hq = merge_histograms_sequential([H1, H2], 3)
    print("H* (Algorithm 1):", _host(Hq.boundaries), _host(Hq.sizes))
    assert np.allclose(_host(Hs.boundaries), [2, 7, 18, 30])
    assert np.allclose(_host(Hs.sizes), [9, 9, 9])

    # --- the guarantee at scale ----------------------------------------------
    rng = np.random.default_rng(0)
    k, n_per = 16, 65_536
    beta = 254                     # Oracle's default bucket count (paper §7)
    T = 40 * beta                  # paper's rule for ≤5 % bucket-size error
    parts = [rng.gumbel(size=n_per).astype(np.float32) for _ in range(k)]
    summaries = [build_exact(p, T, device=device) for p in parts]
    merged = merge_list(summaries, beta)
    N = k * n_per
    err = np.abs(_host(merged.sizes) - N / beta).max()
    bound = theoretical_eps_max(N, T, k, exact_inputs=False)
    print(f"\nN={N:,}  T={T}  beta={beta}")
    print(f"max bucket-size error: {err:.1f}  (bound {bound:.1f}, "
          f"= {err/(N/beta)*100:.2f}% of ideal bucket; guarantee ≤5%)")
    assert err <= bound and err / (N / beta) <= 0.05
    # the guarantee on the data itself: the true occupancy of the merged
    # buckets (the bucket count) is within the bound too
    true = _host(bucket_sizes(np.concatenate(parts), merged.boundaries, device=device))
    assert true.sum() == N and np.abs(true - N / beta).max() <= bound
    print("p95 of the merged histogram:", float(quantile(merged, 0.95)))
    print("quickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu runs the plain versions (default: the card)")
    main(ap.parse_args().device)
