"""Milliseconds a batch spends in the program's ``merge`` span: the host
merge of every block's top-k and the liveness filter."""
from portbench.readings import ms_per_batch


def read(r):
    return ms_per_batch(r, "merge")
