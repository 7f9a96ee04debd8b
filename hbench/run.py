"""Run one cell of the benchmark once; the last line of standard output
is the result.

    python3 hbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  Without the program (``src/repro_torch``),
without a CUDA device, or with fewer than the cell asks for, it exits with 2
and prints no result.  It also
exits with 2 if JAX, Flax or the JAX package of this repository was
imported by the time the window closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the native libraries: their idle workers spin on the
# cores the program's own threads need, and the runs spread the wider
os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import importlib.util

    if importlib.util.find_spec("repro_torch") is None:
        print(f"no program to run: repro_torch is not under {os.path.join(ROOT, 'src')}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)

    from hbench.harness import cell_parts, load_bench, run_cell

    print(f"started: python and torch imported in {time.perf_counter() - T0:.3f} s", file=sys.stderr, flush=True)
    bench = load_bench(ROOT)
    cell = cell_parts(bench, args.workload, ROOT)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); none usable here", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"the run imported {', '.join(bad)}; no result", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
