"""Find the knee of an open-loop cell: the highest Poisson rate at which
the served rate keeps up and the queue does not grow.

    python3 hbench/sweep.py --workload tenants.windows --seed N --seconds 6 --rates 5000 10000 20000

One set-up, then each rate in turn for ``--seconds``.  A rate is held
when the window's last quarter of requests waits no longer than its first
quarter (median latency, within 2x or 5 ms) and the loop ends within
0.25 s of the window.  Prints one JSON line a rate; the cell's traffic
file then fixes 4/5 of the knee.
"""
import argparse
import json
import os
import sys

# one host thread for the native libraries: their idle workers spin on the
# cores the program's own threads need, and the runs spread the wider
os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from hbench.harness import _open_loop, cell_parts, load_bench, new_record, set_up, with_deferred
    from hbench.trace import Tracer

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _, cfg, traffic = cell_parts(with_deferred(load_bench(ROOT), ROOT), args.workload, ROOT)
    pool, sysobj = set_up(cfg, traffic, args.seed, "cuda")
    off = Tracer(False, 0.0, 0.0)
    for k, rate in enumerate(args.rates):
        rec = new_record()
        _open_loop(sysobj, pool, {**traffic, "rate_per_s": rate, "check_answers": 0},
                   args.seconds, args.seed + k, off, rec)
        lat = rec["latency_s"]
        q = max(1, lat.size // 4)
        first, last = float(np.median(lat[:q])), float(np.median(lat[-q:]))
        held = rec["elapsed"] <= args.seconds + 0.25 and (last <= 2 * first or last - first <= 0.005)
        print(json.dumps({
            "rate_per_s": rate, "served_per_s": rec["requests"] / rec["elapsed"], "held": held,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3, "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "first_quarter_ms": first * 1e3, "last_quarter_ms": last * 1e3, "overrun_s": rec["elapsed"] - args.seconds,
            "failed": rec["failed"],
        }), flush=True)
    sysobj.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
