"""Host time of ingest's padding and stacking (the program's ``store.pad``
and ``store.stack`` spans, over the whole window), in ms a billion real
values ingested; ``None`` where the program keeps no such spans."""


def read(run):
    c = run["counters"]
    pad, stack = c.get("span_ns.store.pad"), c.get("span_ns.store.stack")
    if pad is None or stack is None or not c.get("values"):
        return None
    return (pad + stack) * 1e-6 / (c["values"] * 1e-9)
