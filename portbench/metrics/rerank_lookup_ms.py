"""Milliseconds a batch spends in the int8 rerank's ``rerank_lookup`` span:
the unique candidates, their fp32 rows from the point store
(``SegmentManager.get_points``) and each slot's position."""
from portbench.readings import ms_per_batch


def read(r):
    return ms_per_batch(r, "rerank_lookup")
