"""Row-sort launches (``LAUNCHES["tile_sort"]``) a partition ingested,
over the whole window."""


def read(run):
    c = run["counters"]
    return c["tile_sort"] / c["partitions"] if c.get("partitions") else None
