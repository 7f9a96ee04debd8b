"""Bytes of host staging arrays ingest wrote (the program's
``ingest.host_copy_bytes``: the narrowing copy, mixed-dtype casts and
contiguous copies of strided rows; the sort's padded input is built on
the device and counts nothing) a real value ingested, over the whole
window; ``None`` where the program keeps no such counter."""


def read(run):
    c = run["counters"]
    copied = c.get("ingest.host_copy_bytes")
    if copied is None or not c.get("values"):
        return None
    return copied / c["values"]
