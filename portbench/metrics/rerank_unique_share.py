"""Rows the int8 rerank looked up, as a share of the candidate slots that
held a gid (%), over the traced window: the program's
``rerank_rows_total`` over ``rerank_candidates_total``."""
ROWS = "rerank_rows_total"
CANDIDATES = "rerank_candidates_total"


def read(r):
    if ROWS not in r.counters or r.counters.get(CANDIDATES, 0) <= 0:
        return None
    return 100.0 * r.counters[ROWS] / r.counters[CANDIDATES]
