"""Chaos harness: drive a persistent manager through a lifecycle tape under
a seeded fault schedule and recover from every injected crash.

The property it checks is the one the resilience substrate exists for: no
fault schedule yields a silently wrong answer.  Every query the faulted
run answers must be bit for bit the fault-free oracle's, and a crashed
write path recovers by restoring from disk and re-applying the
interrupted operation only where it did not land (one WAL record per
ingest, so a crash never half-applies one; delete / seal / compact are
idempotent).

:func:`lifecycle_ops` is a structured tape that reaches every fault
point on a budgeted, persistent manager; :func:`run_chaos` replays a tape
against a manager.  The tests and ``chip_smoke.py`` phase 5d use them.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from ..core import IntervalFilter
from .resilience import FAULT_POINTS, FaultError

__all__ = ["CRASH_POINTS", "lifecycle_ops", "apply_op", "run_chaos"]

# every crash-capable fault point a chaos run draws from; query.bucket
# fires only on the deadline dispatch path and is hit (never crashed)
# by queries that carry a deadline
CRASH_POINTS = tuple(p for p in FAULT_POINTS if p != "query.bucket")


def lifecycle_ops(seed: int, n_points: int, d: int,
                  n_query: int = 8) -> list:
    """A structured lifecycle tape over ``n_points`` points of width ``d``
    (3 metadata columns, time in the last) that reaches every fault point
    of a persistent manager under a device budget.

    Batches of varied sizes (1/32 to 1/6 of ``n_points``, so the sealed
    segments fall into several capacity buckets) each carry one time unit
    and are ingested and sealed; after every seal a query of ``n_query``
    rows reads the window ``[t - 2.5, t]`` (drifting forward: the newest
    buckets turn hot, older ones cold); every second cycle deletes 2% of
    the points so far, every third compacts.  Then four queries walk the
    window back in time (a backfill reader), so the prefetch predictor
    targets the cold, older buckets.  Payloads are drawn up front from
    ``seed``."""
    window = 2.5
    rng = np.random.default_rng(seed)
    ops, n, t, j = [], 0, 0.0, 0
    lo, hi = max(1, n_points // 32), max(2, n_points // 6)

    def query(t_hi):
        q = rng.normal(size=(n_query, d)).astype(np.float32)
        filt = IntervalFilter(dim=2, lo=np.float32(t_hi - window),
                              hi=np.float32(t_hi))
        ops.append(("query", q, filt))

    while n < n_points:
        b = min(int(rng.integers(lo, hi)), n_points - n)
        x = rng.normal(size=(b, d)).astype(np.float32)
        s = rng.uniform(size=(b, 3))
        s[:, 2] = t + np.linspace(0.0, 0.999, b)
        ops.append(("ingest", x, s))
        ops.append(("seal",))
        n += b
        t += 1.0
        query(t)
        if j % 2 == 1:
            ops.append(("delete", rng.integers(0, n, size=max(
                1, int(0.02 * n)))))
        if j % 3 == 2:
            ops.append(("compact",))
        j += 1
    for i in range(1, 5):
        query(t - i * window / 2)
    ops.append(("seal",))
    return ops


def apply_op(mgr, op, deadline_ms: Optional[float] = None):
    """Apply one tape op; a query (k = 10) returns its ``QueryResult``,
    every other op None.  ``deadline_ms`` goes to queries (a generous one
    keeps the answer exact and drives the per-bucket ``query.bucket``
    path)."""
    kind = op[0]
    if kind == "ingest":
        mgr.ingest(op[1], op[2])
    elif kind == "delete":
        mgr.delete(op[1])
    elif kind == "seal":
        mgr.seal()
    elif kind == "compact":
        mgr.compact()
    else:
        return mgr.query(op[1], op[2], k=10, deadline_ms=deadline_ms)
    return None


def run_chaos(mgr, ops: list, want: List, inj, restore: Callable,
              deadline_ms: Optional[float] = None) -> dict:
    """Replay ``ops`` on ``mgr`` (with ``inj`` installed) and recover from
    every injected :class:`~.resilience.FaultError`: a query is retried
    (reads mutate nothing durable); any other op restores the manager
    with ``restore()`` (which must install ``inj`` on the new manager) and
    is re-applied unless it already landed (an ingest whose WAL record is
    durable).  Each query answer must equal ``want[i]`` (the fault-free
    oracle's answer to op ``i``) bit for bit and must not be degraded;
    a mismatch raises ``AssertionError``.  An op gets ten attempts; the
    injector is disarmed from the eighth on, on top of its ``max_faults``
    cap (the reference test's rule).

    Returns ``{"mgr": the final manager, "faults": crashes caught,
    "restores": restores made, "recovery_s": [seconds per restore],
    "queries": answers checked}``."""
    faults = 0
    recovery: List[float] = []
    checked = 0
    for i, (op, w) in enumerate(zip(ops, want)):
        for attempt in range(10):
            pre_n = mgr.n_total
            try:
                got = apply_op(mgr, op, deadline_ms=deadline_ms)
            except FaultError:
                faults += 1
                if attempt >= 7:
                    inj.disarm()
                if op[0] == "query":
                    continue
                t0 = time.perf_counter()
                mgr = restore()
                recovery.append(time.perf_counter() - t0)
                if op[0] == "ingest" and mgr.n_total > pre_n:
                    break
                continue
            if op[0] == "query":
                if not (np.array_equal(w[0], got[0])
                        and np.array_equal(w[1], got[1])):
                    raise AssertionError(
                        f"op {i} (query): the answer differs from the "
                        f"fault-free oracle's (fired {inj.fired})")
                if got.degraded:
                    raise AssertionError(f"op {i} (query): degraded "
                                         f"{got.reasons}")
                checked += 1
            break
        else:
            raise AssertionError(f"op {i} ({op[0]}) never converged "
                                 f"(fired {inj.fired})")
    return {"mgr": mgr, "faults": faults, "restores": len(recovery),
            "recovery_s": recovery, "queries": checked}
