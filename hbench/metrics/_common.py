"""What the readers share: the kernel names of the program's CUDA sources,
device time by span and name, and the idle share of the stretch.

A row sort is ``row_sort.cu``'s path (``radix_sort.cuh``'s resident or
onesweep passes, then the cut gather); a merge is ``merge_cut.cu``'s, with
the kv sort it runs first when its problem is too long for one block.
A reader counts a kernel by its name and by the harness span (``ingest``
or ``query``) inside which it was launched.
"""
SORT = ("onesweep_kernel", "histogram_kernel", "digit_scan_kernel", "gather_cuts_kernel", "resident_kernel")
MERGE = ("merge_kernel",) + SORT


def device_seconds(trace: dict, span: str, names=None, cat: str | None = None) -> float:
    total = 0.0
    lo, hi = trace["stretch"]
    for name, c, s, e, sp in trace["device"]:
        if sp != f"hbench.{span}" or (cat is not None and c != cat):
            continue
        if names is not None and not any(k in name for k in names):
            continue
        total += min(e, hi) - max(s, lo)
    return total * 1e-6


def idle_percent(trace) -> float | None:
    """``1 - union(kernel, copy and memset intervals) / stretch``, in %."""
    if not trace:
        return None
    lo, hi = trace["stretch"]
    return 100.0 * (1.0 - trace["busy_us"] / (hi - lo)) if hi > lo else None
