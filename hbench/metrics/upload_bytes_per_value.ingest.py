"""Bytes ingest copied from host arrays into the row sort's input buffer
(the program's ``ingest.upload_bytes``) a real value ingested, over the
whole window; ``None`` where the program keeps no such counter."""


def read(run):
    c = run["counters"]
    uploaded = c.get("ingest.upload_bytes")
    if uploaded is None or not c.get("values"):
        return None
    return uploaded / c["values"]
