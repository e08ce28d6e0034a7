"""95th percentile batch latency of the untraced window of a traced run,
in a host-paced cell (``PERF.md``)."""


def read(r):
    return r.window.get("p95_ms")
