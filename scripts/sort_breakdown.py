#!/usr/bin/env python3
"""Device time of the port's radix sort, kernel by kernel, on one GPU.

Run from the repository root::

    python3 scripts/sort_breakdown.py

For each shape (the row sort and the kv sort at the kernels line's shapes,
a skewed int32 case, and resident rows of 4,096 / 16,384 / 32,768 keys),
one warm call, then three calls under ``torch.profiler``: prints one JSON
line a shape with the device ms per call of each kernel (histogram, scan,
onesweep passes, resident block) and the CUDA-event ms per call.  Each
shape is first held to ``torch.sort``.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

REPS = 3


def per_kernel_ms(fn) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            if t > 0:
                out[e.key[:70]] = out.get(e.key[:70], 0.0) + t / 1e3 / REPS
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("sort_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    gumbel = lambda r, w: -torch.log(-torch.log(torch.rand((r, w), generator=g, device=dev)))  # noqa: E731
    shapes = [
        ("row 256x2^20 gumbel", "row", gumbel(256, 1 << 20)),
        ("row 64x2^16 i32 ties", "row", torch.randint(-50, 50, (64, 1 << 16), generator=g, device=dev, dtype=torch.int32)),
        ("row 65536x4096 uniform (resident)", "row", torch.rand((65536, 4096), generator=g, device=dev)),
        ("row 16384x16384 uniform (resident)", "row", torch.rand((16384, 16384), generator=g, device=dev)),
        ("row 8192x32768 uniform (resident)", "row", torch.rand((8192, 32768), generator=g, device=dev)),
        ("kv 1000x65536 gumbel", "kv", gumbel(1000, 65536)),
        ("pairs 1000x65056 gumbel (L=65536)", "pairs", gumbel(1000, 65056)),
        ("kv 16384x16384 uniform (resident)", "kv", torch.rand((16384, 16384), generator=g, device=dev)),
    ]
    for name, kind, x in shapes:
        if kind == "row":
            fn = lambda: kernels.sort_rows(x)  # noqa: E731
            assert torch.equal(fn(), torch.sort(x, dim=-1).values), name
        elif kind == "kv":
            v = torch.arange(x.numel(), device=dev, dtype=torch.int32).view(x.shape)
            fn = lambda: kernels.sort_kv(x, v)  # noqa: E731
            assert torch.equal(fn()[1], ref.sort_kv_ref(x, v)[1]), name
        else:
            fn = lambda: kernels.argsort_pairs(x, 65536)  # noqa: E731
            assert torch.equal(fn(), ref.argsort_pairs_ref(x, 65536)), name
        torch.cuda.synchronize()
        print(json.dumps({"shape": name, "event_ms": event_ms(fn), "kernels_ms": per_kernel_ms(fn)}), flush=True)
        del x
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
