"""Queries per second of the untraced window of a traced run, in a cell
whose device idles most of the window (the host-paced rule, ``PERF.md``)."""


def read(r):
    return r.window.get("qps")
