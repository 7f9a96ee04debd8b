"""Device time of the host-to-device copies that ingest started in the
traced stretch, in ms a billion real values ingested there."""
from hbench.metrics._common import device_seconds


def read(run):
    tr = run["trace"]
    if not tr or not tr["ingest_ns"]:
        return None
    h2d = device_seconds(tr, "ingest", ("HtoD",), "gpu_memcpy")
    return h2d * 1e3 / (sum(tr["ingest_ns"]) / 1e9) if h2d > 0 else None
