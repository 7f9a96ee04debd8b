#!/usr/bin/env python3
"""Device time of the bucket count at the main path's shapes and at scale,
for one tree's ``repro_torch``, on one GPU.

Run from the repository root::

    python3 scripts/bucket_count_sweep.py [--src DIR]

``--src`` times the ``repro_torch`` under ``DIR`` (for example an unpacked
earlier commit) with this tree's measurements, so that two versions can be
compared in one run: run it as parent, change, change, parent.  Prints JSON
lines:

- the main path's three shapes of ``chip_smoke.bucket_count_shapes`` (each
  held to its plain version first): device µs a call by item, wall µs and
  launches a call;
- the scale shape, 365 × 2^20 Gumbel values against 255 of their
  quantiles, then the same shape over one value and over b_T only: device
  ms a call (all device operations of one ``counts`` call, from a
  ``torch.profiler`` trace of 5 calls) and CUDA-event ms a call, beside the
  bound.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bucket_count_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import bucket_count, ref

    dev = torch.device("cuda", 0)
    tag = {"src": os.path.relpath(os.path.abspath(args.src), ROOT)}
    for row in chip_smoke.bucket_count_shapes(dev):
        print(json.dumps({**tag, **row}), flush=True)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    x = -torch.log(-torch.log(torch.rand(365 << 20, generator=g, device=dev)))
    b = torch.sort(x[: 1 << 24]).values[torch.linspace(0, (1 << 24) - 1, 255, device=dev).long()].contiguous()
    out = {**tag, "n": x.numel(), "T+1": 255, "bound_ms": chip_smoke.bound_ms(4.0 * x.numel(), 0)[0]}
    call = lambda: bucket_count.counts(x, b)
    for name, value in (("spread", None), ("one_value", b[127]), ("b_T_only", b[-1])):
        if value is not None:
            x.fill_(value)
        assert torch.equal(call(), ref.counts_ref(x, b)), name
        out[f"{name}_device_ms"] = chip_smoke.calls_breakdown(call, 5)["device_us"] / 1e3
        out[f"{name}_event_ms"] = chip_smoke.cuda_ms(call)
    print(json.dumps(out), flush=True)
    print(chip_smoke.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
