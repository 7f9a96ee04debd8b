"""Cost of one ``repro_torch.core.spans`` span on this host, with the
profiler off and with a ``torch.profiler`` session (CPU and, where there
is a card, CUDA activities) running.

    PYTHONPATH=src python scripts/span_cost.py [--spans 200000]

Prints one JSON line: µs a span (an empty ``with`` block, the mean over
``--spans`` of them, best of five rounds) in each state, and the device
it ran beside.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import spans


def per_span_us(n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("store.pad"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best * 1e-3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spans", type=int, default=200_000)
    args = ap.parse_args()
    cuda = torch.cuda.is_available()
    off = per_span_us(args.spans)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        on = per_span_us(args.spans // 20)  # each is a trace event: fewer
    print(json.dumps({
        "span_us_profiler_off": off,
        "span_us_profiler_on": on,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }))


if __name__ == "__main__":
    main()
