"""Merge launches (``LAUNCHES["merge_cut"]``) a request answered, over the
whole window."""


def read(run):
    c = run["counters"]
    return c["merge_cut"] / c["requests"] if c.get("requests") else None
