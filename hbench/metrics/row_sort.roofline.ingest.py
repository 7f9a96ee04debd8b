"""The row sort's share of its roofline in the traced stretch: the least
time for the bytes of the real values it summarized (``cost.row_sort_bytes``
a partition, never its padding) over the device time of the row-sort
kernels launched by ingest, in %."""
from hbench import cost
from hbench.metrics._common import SORT, device_seconds


def read(run):
    tr = run["trace"]
    if not tr or not tr["ingest_ns"]:
        return None
    busy = device_seconds(tr, "ingest", SORT, "kernel")
    if busy <= 0:
        return None
    T = int(run["config"]["num_buckets"])
    least = cost.least_seconds(sum(cost.row_sort_bytes(n, T) for n in tr["ingest_ns"]))
    return 100.0 * least / busy
