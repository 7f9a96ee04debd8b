"""Share of the window's lookups that the interval tree's answer cache
answered: ``hits / (hits + misses)``, in %."""


def read(run):
    c = run["counters"]
    looked = c["cache_hits"] + c["cache_misses"]
    return 100.0 * c["cache_hits"] / looked if looked else None
