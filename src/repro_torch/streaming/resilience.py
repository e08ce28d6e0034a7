"""Resilience substrate used by the default streaming path: supervised
background workers and query deadlines.

* :class:`Supervisor` — owns the manager's background workers
  (``compact_async``).  A supervised run retries a failing worker with
  bounded exponential backoff; a worker that keeps failing past its error
  budget trips a sticky per-worker ``degraded`` flag.  Every error lands
  in the obs registry (``worker_errors_total{worker=...}`` et al.) and in
  the :meth:`Supervisor.health` snapshot that ``SegmentManager.stats()``
  surfaces under ``"health"``.

* :class:`Deadline` / :class:`QueryResult` — per-query time budgets.  The
  query path checks :meth:`Deadline.expired` between segment searches
  and, on overrun, returns the partial result explicitly marked
  ``degraded=True`` with per-reason skip counts.  ``QueryResult``
  subclasses ``tuple`` so ``g, d = manager.query(...)`` unpacks as usual.

Fault injection (the reference's ``FaultInjector`` and its fault points)
is not ported yet.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

__all__ = ["Supervisor", "Deadline", "QueryResult"]


class _WorkerState:
    """Mutable per-worker bookkeeping inside a :class:`Supervisor`."""

    __slots__ = ("runs", "errors", "retries", "restarts",
                 "consecutive_failures", "degraded", "last_error")

    def __init__(self):
        self.runs = 0                 # completed successful runs
        self.errors = 0               # failed attempts (incl. retried)
        self.retries = 0              # in-run retry attempts
        self.restarts = 0             # fresh runs after a failed run
        self.consecutive_failures = 0  # whole runs failed in a row
        self.degraded = False         # error budget tripped (sticky until
        self.last_error = None        # a run succeeds)


class Supervisor:
    """Bounded-retry supervisor for the manager's background workers.

    :meth:`run` executes a worker function with up to ``max_retries``
    retries under exponential backoff (``backoff_base_s * 2**attempt``,
    capped at ``backoff_max_s``).  A whole run that still fails counts
    against the worker's error budget; ``error_budget`` consecutive
    failed runs trip the worker's ``degraded`` flag, cleared by the next
    successful run.  Every failure records the traceback tail and bumps
    the registry counters — nothing a daemon thread does can vanish
    silently anymore:

    * ``worker_errors_total{worker=w}`` — failed attempts;
    * ``worker_retries_total{worker=w}`` — backoff retries;
    * ``worker_restarts_total{worker=w}`` — fresh runs after a failure;
    * ``worker_degraded{worker=w}`` (gauge) — 1 while degraded.

    :meth:`health` returns the JSON-safe snapshot ``stats()["health"]``
    exposes.
    """

    def __init__(self, registry=None, max_retries: int = 2,
                 backoff_base_s: float = 0.02, backoff_max_s: float = 1.0,
                 error_budget: int = 3,
                 sleep: Callable[[float], None] = time.sleep):
        from ..obs.metrics import NULL_REGISTRY
        self.registry = NULL_REGISTRY if registry is None else registry
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.error_budget = int(error_budget)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerState] = {}
        self._threads: Dict[str, threading.Thread] = {}

    def _state(self, name: str) -> _WorkerState:
        st = self._workers.get(name)
        if st is None:
            st = self._workers[name] = _WorkerState()
        return st

    def _record_failure(self, name: str, st: _WorkerState) -> None:
        st.errors += 1
        st.last_error = traceback.format_exc(limit=8)
        self.registry.counter(
            f'worker_errors_total{{worker="{name}"}}').inc()

    def note_error(self, name: str, exc: BaseException) -> None:
        """Record an inline (non-retried) worker failure — for call sites
        that must fall back at once (a pack-delta failure invalidates the
        pack rather than retrying under the lock) but must never drop the
        error."""
        with self._lock:
            st = self._state(name)
            st.errors += 1
            st.consecutive_failures += 1
            st.last_error = "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__, limit=8))
            if st.consecutive_failures >= self.error_budget:
                st.degraded = True
            self.registry.counter(
                f'worker_errors_total{{worker="{name}"}}').inc()
            self.registry.gauge(
                f'worker_degraded{{worker="{name}"}}').set(
                    1.0 if st.degraded else 0.0)

    def run(self, name: str, fn: Callable[[], object]):
        """Run ``fn`` as worker ``name`` with bounded retry + backoff.

        Returns ``fn``'s result on (eventual) success.  After exhausting
        retries the run counts one consecutive failure (possibly tripping
        ``degraded``) and returns None — the error itself lives on in
        ``health()`` and the registry, never re-raised into the daemon
        thread where it would vanish.
        """
        with self._lock:
            st = self._state(name)
            if st.consecutive_failures > 0:
                st.restarts += 1
                self.registry.counter(
                    f'worker_restarts_total{{worker="{name}"}}').inc()
        for attempt in range(self.max_retries + 1):
            try:
                result = fn()
            except Exception:
                with self._lock:
                    self._record_failure(name, st)
                    final = attempt >= self.max_retries
                    if final:
                        st.consecutive_failures += 1
                        if st.consecutive_failures >= self.error_budget:
                            st.degraded = True
                    else:
                        st.retries += 1
                        self.registry.counter(
                            f'worker_retries_total{{worker="{name}"}}').inc()
                    self.registry.gauge(
                        f'worker_degraded{{worker="{name}"}}').set(
                            1.0 if st.degraded else 0.0)
                if final:
                    return None
                self._sleep(min(self.backoff_base_s * (2.0 ** attempt),
                                self.backoff_max_s))
            else:
                with self._lock:
                    st.runs += 1
                    st.consecutive_failures = 0
                    st.degraded = False
                    self.registry.gauge(
                        f'worker_degraded{{worker="{name}"}}').set(0.0)
                return result
        return None                      # pragma: no cover - unreachable

    def spawn(self, name: str, fn: Callable[[], object]
              ) -> threading.Thread:
        """Run ``fn`` supervised on a daemon thread (at most one alive
        per worker name — the ``compact_async`` discipline).  Returns the
        (possibly already running) thread."""
        with self._lock:
            t = self._threads.get(name)
            if t is not None and t.is_alive():
                return t
            t = threading.Thread(target=lambda: self.run(name, fn),
                                 daemon=True, name=f"cubegraph-{name}")
            self._threads[name] = t
        t.start()
        return t

    def degraded(self, name: str) -> bool:
        """Whether worker ``name`` has tripped its error budget."""
        with self._lock:
            st = self._workers.get(name)
            return bool(st is not None and st.degraded)

    def health(self) -> Dict[str, dict]:
        """JSON-safe per-worker snapshot for ``stats()["health"]``."""
        with self._lock:
            return {
                name: {
                    "runs": st.runs,
                    "errors": st.errors,
                    "retries": st.retries,
                    "restarts": st.restarts,
                    "consecutive_failures": st.consecutive_failures,
                    "degraded": st.degraded,
                    "last_error": st.last_error,
                }
                for name, st in self._workers.items()
            }


class Deadline:
    """Monotonic per-query time budget.

    Created at query entry from ``StreamConfig(query_deadline_ms=)`` or
    the per-call ``query(deadline_ms=)`` override; the query path asks
    :meth:`expired` between bucket dispatches and the planner prices
    decisions against :meth:`remaining_ms`.  ``Deadline.start(None)``
    returns None — the no-deadline hot path stays a single ``is None``
    check with zero clock reads.
    """

    __slots__ = ("budget_ms", "_t0")

    def __init__(self, budget_ms: float):
        self.budget_ms = float(budget_ms)
        self._t0 = time.perf_counter()

    @classmethod
    def start(cls, budget_ms: Optional[float]) -> Optional["Deadline"]:
        """A running deadline, or None when no budget is set."""
        return None if budget_ms is None else cls(budget_ms)

    def remaining_ms(self) -> float:
        """Milliseconds left (negative once overrun)."""
        return self.budget_ms - (time.perf_counter() - self._t0) * 1e3

    def expired(self) -> bool:
        """Whether the budget is spent."""
        return self.remaining_ms() <= 0.0


class QueryResult(tuple):
    """A query's result tuple, annotated with degraded-mode metadata.

    Subclasses ``tuple`` so ``g, d = manager.query(...)`` (and the
    ``return_stats`` / ``return_trace`` arities) unpack exactly as
    before.  ``degraded`` is True when any bucket was skipped to honor a
    deadline — the partial answer covers only the buckets dispatched
    before the budget ran out; ``reasons`` maps each skip reason (e.g.
    ``"deadline_sealed_scan"``, ``"deadline_graph"``,
    ``"deadline_planner"``) to the number of buckets skipped for it.
    Without a deadline (the default), ``degraded`` is always False and
    results carry the usual exactness guarantees.
    """

    degraded: bool
    reasons: Dict[str, int]

    def __new__(cls, items: Tuple, degraded: bool = False,
                reasons: Optional[Dict[str, int]] = None) -> "QueryResult":
        """Wrap an ordinary result tuple with degraded-mode metadata."""
        self = super().__new__(cls, items)
        self.degraded = bool(degraded)
        self.reasons = dict(reasons or {})
        return self
