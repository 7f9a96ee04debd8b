"""Each cell cut to a size the CPU tests run in about a second: the same
loops, adapters, reference and checks, on the plain versions of the
program's kernels (``device="cpu"``)."""
from __future__ import annotations

import copy

CONFIG = {
    "paper_month": {"values_per_partition": 5000, "num_buckets": 64, "pool_partitions": 7},
}
TRAFFIC = {
    "daily_publish": {"beta": 16},
    "windows_uniform": {"beta": 16, "rate_per_s": 300, "check_answers": 100},
}


def overrides(cell: dict) -> dict:
    return copy.deepcopy({"config": CONFIG[cell["config"]], "traffic": TRAFFIC[cell["traffic"]]})
