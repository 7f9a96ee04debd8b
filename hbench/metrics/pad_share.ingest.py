"""Share of the values the row sort received that were padding (the
program's ``ingest.padded_values``: sentinels and duplicated rows), over
the whole window, in %; ``None`` where the program keeps no such counter."""


def read(run):
    c = run["counters"]
    padded = c.get("ingest.padded_values")
    if padded is None or not c.get("values"):
        return None
    return 100.0 * padded / (padded + c["values"])
