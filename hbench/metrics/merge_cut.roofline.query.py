"""The merge's share of its roofline in the traced stretch: the least time
for the bytes of the windows the answer cache missed, over the device time
of the merge kernels launched by queries, in %.

A window's bytes are ``cost.merge_bytes`` of the canonical node count of
``[lo, hi]``.  A batch reports only how many windows missed, so it counts
that many of its distinct windows, the ones with the fewest nodes: the
bytes are never more than the work needed."""
from hbench import cost
from hbench.metrics._common import MERGE, device_seconds


def read(run):
    tr = run["trace"]
    if not tr or not tr["query_batches"]:
        return None
    busy = device_seconds(tr, "query", MERGE, "kernel")
    if busy <= 0:
        return None
    T, beta = int(run["config"]["num_buckets"]), int(run["traffic"]["beta"])
    nbytes = 0.0
    for windows, misses in tr["query_batches"]:
        nodes = sorted(cost.canonical_nodes(lo, hi) for _, lo, hi in windows)[: max(0, misses)]
        nbytes += sum(cost.merge_bytes(c, T, beta) for c in nodes)
    if nbytes <= 0:
        return None
    return 100.0 * cost.least_seconds(nbytes) / busy
