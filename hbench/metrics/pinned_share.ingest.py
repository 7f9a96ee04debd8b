"""Share of the bytes ingest copied from host arrays into the row sort's
input buffer (the program's ``ingest.upload_bytes``) that went through a
pinned staging ring (``ingest.pinned_bytes``), over the whole window, in
%; ``None`` where the program lacks either counter, or the window
ingested nothing."""


def read(run):
    c = run["counters"]
    pinned, uploaded = c.get("ingest.pinned_bytes"), c.get("ingest.upload_bytes")
    if pinned is None or not uploaded or not c.get("values"):
        return None
    return 100.0 * pinned / uploaded
