"""Milliseconds a batch spends in the program's ``merge_topk`` span: the
host's exact top-k over every block's candidates, the merge without the
liveness filter."""
from portbench.readings import ms_per_batch


def read(r):
    return ms_per_batch(r, "merge_topk")
