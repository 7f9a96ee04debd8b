"""Host time of the interval tree's upkeep on ingest (the program's
``store.tree_update`` and ``store.retention`` spans: leaf writes, pull-up
merges, evictions and collapse, over the whole window), in ms a partition
ingested; ``None`` where the program keeps no such spans."""


def read(run):
    c = run["counters"]
    tree, retention = c.get("span_ns.store.tree_update"), c.get("span_ns.store.retention")
    if tree is None or retention is None or not c.get("partitions"):
        return None
    return (tree + retention) * 1e-6 / c["partitions"]
