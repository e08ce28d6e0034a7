"""The scan kernels' share of their roofline (%), on this cell's inputs.

The least time (``peaks.scan_bound_s``: the live sealed rows inside each
box, times the batch, times 2d at the fp32 peak, or those rows read once
at the HBM bandwidth, whichever is longer) of the traced window's batches,
over the device time of every operation inside the program's
``bucket_dispatch`` spans (the scan kernels, B1 in fp32 and B3 in int8,
and the merges of their lists).  Reads nothing where the planner sent a
bucket to the graph traversal: that work is not the counted scan."""
GRAPH = 'planner_decision_total{mode="graph"}'


def read(r):
    if r.trace is None or r.counters.get(GRAPH, 0.0) > 0:
        return None
    device_s = r.trace.device_s_within("bucket_dispatch")
    if device_s <= 0 or r.bound_s <= 0:
        return None
    return 100.0 * r.bound_s / device_s
