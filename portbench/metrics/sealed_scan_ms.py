"""Milliseconds a batch spends in the program's ``sealed_scan`` span: the
sealed pack's dispatch, its kernels and, in int8, the rerank."""
from portbench.readings import ms_per_batch


def read(r):
    return ms_per_batch(r, "sealed_scan")
