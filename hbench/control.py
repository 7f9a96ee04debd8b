"""Run a cell with the control in the program's place (the reference one
precision down, ``reference/control.py``), or the program itself, on
several seeds in one process, and print each run's compared numbers.

    python3 hbench/control.py --workload paper_month.daily --seconds 8 --seeds 11 12 13 [--program]
    python3 hbench/control.py --workload qwen3_8b.offline --seconds 1 --seeds 11 12 --fault kv_cache_unwritten

The benchmark's own runs never run the control; this is how its readings
and the program's are taken for the limits (PERF.md, section 2).  With
``--fault`` the program runs with that fault of ``faults.py`` or of a
``planted/<config>.py`` planted underneath, at the cell's own size.
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
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true", help="run the program instead of the control")
    ap.add_argument("--fault", help="run the program with this fault (faults.py, planted/) planted")
    args = ap.parse_args()

    import pytest
    import torch

    torch.set_num_threads(1)

    from hbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    program = args.program or bool(args.fault)
    side = args.fault or ("program" if program else "control")
    for seed in args.seeds:
        with pytest.MonkeyPatch.context() as mp:
            if args.fault:
                from hbench.faults import planted

                planted()[0][args.fault](mp)
            out = harness.run_cell(args.workload, seed, args.seconds, False, control=not program)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": side, "correct": out["correct"],
                          "attempted": out["attempted"], "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
