#!/usr/bin/env python3
"""Device time of the batched merge at the main path's merge shapes and at
the timed shape, for one tree's ``repro_torch``, on one GPU.

Run from the repository root, after ``python3 chip_smoke.py`` has written
the main path's shapes to ``build/merge_shapes.json``::

    python3 scripts/merge_sweep.py [--src DIR] [--shapes FILE]

``--src`` times the ``repro_torch`` under ``DIR`` (for example an unpacked
earlier commit) with this tree's measurements, so that two versions can be
compared in one run: run it as parent, change, change, parent.  Every call
goes through ``merge_batched`` with no ``regime`` argument, so each tree
takes its own path.  Prints JSON lines:

- each ``(Q, k, T+1, β)`` of the shapes file (seeded inputs, held bit-equal
  to the plain version first): device µs a call by item and wall µs over
  20 back-to-back calls (``chip_smoke.calls_breakdown``), launches a call;
- the timed shape, Q=1000, k=32, T=2032, β=254: CUDA-event ms a call, and
  device ms a call split into the kv sort and the merge's own kernels.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the merge's own kernels in a trace: this tree's, and the three-launch
# design's scan and cut
OWN = ("::resident_merge_kernel", "::long_merge_kernel", "::scan_kernel", "::cut_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--shapes", default=os.path.join(ROOT, "build", "merge_shapes.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("merge_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch import kernels
    from repro_torch.kernels import ref

    with open(args.shapes) as f:
        seen = {tuple(row[:5]): row[5] for row in json.load(f)}
    dev = torch.device("cuda", 0)
    tag = {"src": os.path.relpath(os.path.abspath(args.src), ROOT)}
    for row in chip_smoke.merge_shape_times(dev, seen, regimes=False):
        print(json.dumps({**tag, **row}), flush=True)
    rng = np.random.default_rng(chip_smoke.SEED)
    b, s = chip_smoke.summary_inputs(rng, 1000, 32, 150_000, 250_000, False, dev)
    beta = chip_smoke.BETA
    call = lambda: kernels.merge_batched(b, s, beta)
    assert chip_smoke.merge_bits_equal(call(), ref.merge_ref(b, s, beta))
    items = chip_smoke.calls_breakdown(call, 5)["device_us_by_item"]
    own = sum(t for key, t in items.items() if any(k in key for k in OWN))
    if own <= 0:
        raise RuntimeError(f"no merge kernel ({OWN}) in the trace: {sorted(items)}")
    print(json.dumps({**tag, "shape": "Q=1000 k=32 T=2032 beta=254", "event_ms": chip_smoke.cuda_ms(call),
                      "device_ms": sum(items.values()) / 1e3, "kv_sort_ms": (sum(items.values()) - own) / 1e3,
                      "scan_and_cut_ms": own / 1e3, "device_us_by_item": items}), flush=True)
    print(chip_smoke.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
