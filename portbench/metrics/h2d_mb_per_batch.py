"""Megabytes (1e6 B) the query path copies from the host to the card per
batch, over the traced window: the sum of the program's
``h2d_bytes_total{site=...}`` counters over ``query_batches_total``."""
PREFIX = "h2d_bytes_total"
BATCHES = "query_batches_total"


def read(r):
    sites = [v for n, v in r.counters.items() if n.startswith(PREFIX)]
    if not sites or r.counters.get(BATCHES, 0) <= 0:
        return None
    return sum(sites) / r.counters[BATCHES] / 1e6
