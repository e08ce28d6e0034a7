"""Milliseconds a batch spends in the int8 rerank's ``rerank_upload`` span:
every copy of the rerank to the card (the looked-up rows, the positions,
the filter block, the queries)."""
from portbench.readings import ms_per_batch


def read(r):
    return ms_per_batch(r, "rerank_upload")
