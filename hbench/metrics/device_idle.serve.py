"""The device's idle share of the traced turn of a served model:
``1 - union(kernel, copy and memset intervals) / stretch``, in %."""
from hbench.metrics._common import idle_percent


def read(run):
    return idle_percent(run["trace"])
