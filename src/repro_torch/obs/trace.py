"""Structured per-query tracing: nested spans that block on device work.

A :class:`QueryTrace` is a tree of :class:`Span` context managers opened
along the query path (delta scan, per-segment search, merge).  Two rules
make the numbers honest under CUDA's asynchronous launches:

* every span body that launches device work calls :func:`block_ready` on
  its results **before** the span closes, so the recorded duration covers
  the device computation, not just the Python-side enqueue;
* every span wraps ``torch.profiler.record_function``, so the same span
  names line up with the kernels in a captured ``torch.profiler`` trace.

What a span records: its ``name``, its ``attrs``, its children (the spans
it caused), its duration ``ms`` on the monotonic ``time.perf_counter``,
and its ``start_ns`` / ``end_ns`` read from ``time.time_ns()`` just
inside its ``record_function`` range, around the ``ms`` reads.  That
wall clock is the profiler's Chrome trace's: an event's ``ts`` (us) is
``time.time_ns()`` less the trace's ``baseTimeNanoseconds``, so a span
tree lays over a device trace; ``ms`` does not move if the wall clock is
stepped.  The root of a :class:`QueryTrace` carries the batch's ``id``
(``SegmentManager.query``: the manager's running count of query
batches), which every span of its tree shares.

The disabled path is a set of shared singletons (:data:`NULL_TRACE` /
its no-op span): opening a span on a disabled trace allocates nothing
and touches no clocks, which is what keeps tracing per-query opt-in
(``SegmentManager.query(..., return_trace=True)``) rather than a
standing tax.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

__all__ = ["NULL_TRACE", "QueryTrace", "Span", "block_ready"]


def _cuda_devices(value, out: set) -> set:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def block_ready(value):
    """Wait for the device work behind ``value`` (tensors, numpy arrays,
    None, or tuples / lists / dicts of them): synchronizes every CUDA
    device a tensor in ``value`` lives on; host values need no wait.

    The query path's timer-stop pattern: call on every dispatch result
    before reading a clock, so measured time includes device execution.
    Returns ``value`` unchanged.
    """
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


class Span:
    """One timed node of a trace tree (use via ``QueryTrace.span``)."""

    __slots__ = ("name", "attrs", "children", "_t0", "duration_ms",
                 "start_ns", "end_ns", "_annotation")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = attrs or {}
        self.children: List[Span] = []
        self._t0 = 0.0
        self.duration_ms = 0.0
        self.start_ns = 0
        self.end_ns = 0
        self._annotation = None

    def annotate(self, **attrs) -> None:
        """Attach key/value attributes (bucket cap, candidate counts...)."""
        self.attrs.update(attrs)

    def start(self) -> "Span":
        """Open the profiler annotation and start the clocks."""
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> None:
        """Stop the clocks and close the profiler annotation.  Callers must
        :func:`block_ready` device results first — that ordering is the
        whole point of the tracer."""
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        self.end_ns = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None

    def to_dict(self) -> dict:
        """JSON-safe ``{name, ms, start_ns, end_ns, attrs?, spans?}``
        subtree."""
        out = {"name": self.name, "ms": round(self.duration_ms, 4),
               "start_ns": self.start_ns, "end_ns": self.end_ns}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["spans"] = [c.to_dict() for c in self.children]
        return out


class _SpanCtx:
    """Context manager that pushes/pops one span on its trace's stack."""

    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "QueryTrace", span: Span):
        self._trace = trace
        self._span = span

    def __enter__(self) -> Span:
        self._trace._stack.append(self._span)
        return self._span.start()

    def __exit__(self, exc_type, exc, tb):
        self._span.stop()
        self._trace._stack.pop()
        return False


class QueryTrace:
    """Span tree for one query; the root span times the whole call.

    Created by ``SegmentManager.query(..., return_trace=True)`` (or
    directly) and threaded through ``streaming.query.query_segments``.
    ``id`` (None: none) names the batch the tree belongs to.  :meth:`finish`
    stops the root; :meth:`to_dict` exports the tree.
    """

    enabled = True

    def __init__(self, name: str = "query", id: Optional[int] = None):
        self.id = id
        self.root = Span(name)
        self._stack: List[Span] = [self.root]
        self.root.start()

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Open a child span of the innermost active span."""
        sp = Span(name, attrs)
        self._stack[-1].children.append(sp)
        return _SpanCtx(self, sp)

    def finish(self) -> "QueryTrace":
        """Stop the root span (idempotent enough for one query's life)."""
        if self.root._annotation is not None:
            self.root.stop()
        return self

    @property
    def total_ms(self) -> float:
        """Root span duration (finish first)."""
        return self.root.duration_ms

    def to_dict(self) -> dict:
        """JSON-safe span tree (root node, with ``id`` when it has one)."""
        out = self.root.to_dict()
        if self.id is not None:
            out["id"] = self.id
        return out


class _NullSpan:
    """Shared no-op span for the disabled trace."""

    __slots__ = ()
    name = "null"
    attrs: dict = {}
    children: list = []
    duration_ms = 0.0

    def annotate(self, **attrs) -> None:
        """No-op."""

    def to_dict(self) -> dict:
        """Empty subtree."""
        return {}


class _NullSpanCtx:
    """Shared no-op span context: no clocks, no allocations."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullSpanCtx()


class _NullTrace:
    """Shared disabled tracer (the default for every query)."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **attrs) -> _NullSpanCtx:
        """Return the shared no-op span context."""
        return _NULL_CTX

    def finish(self) -> "_NullTrace":
        """No-op."""
        return self

    @property
    def total_ms(self) -> float:
        """Always zero."""
        return 0.0

    def to_dict(self) -> dict:
        """Empty tree."""
        return {}


NULL_TRACE = _NullTrace()
