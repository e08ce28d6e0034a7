"""Milliseconds a batch spends in the int8 exact rerank
(``quant/rerank.py::rerank_exact``): the program's ``rerank_fp32`` span,
the over-fetched candidates of the scanned buckets."""
from portbench.readings import ms_per_batch


def read(r):
    return ms_per_batch(r, "rerank_fp32")
