"""Thread-safe metrics registry: counters, gauges, log-bucketed histograms.

Design constraints (in priority order):

* **Near-zero cost when disabled.**  A disabled registry hands out one
  shared :data:`NULL_METRIC` singleton for every name, so instrumented
  code keeps calling ``counter(...).inc()`` unconditionally and pays one
  attribute lookup + no-op call — no branches at call sites, no per-call
  allocations.
* **Bounded memory when enabled.**  Histograms are log-bucketed —
  :data:`SUBBUCKETS` buckets per octave (power of two), so bucket ``i``
  spans ``(V0 * 2**((i-1)/SUBBUCKETS), V0 * 2**(i/SUBBUCKETS)]`` — which
  bounds the relative error of any reported percentile at
  ``2**(1/SUBBUCKETS) - 1`` (~19% with the default 4) while storing only
  a handful of non-empty buckets per metric, independent of observation
  count.
* **Strict JSON end-to-end.**  Every snapshot is serializable with
  ``json.dumps(..., allow_nan=False)``; :func:`json_sanitize` applies the
  persistence layer's inf→null convention to arbitrary stats payloads
  (``SegmentManager.stats()`` reuses it).

:class:`BucketStats` is the rolling per-capacity-bucket observation
accumulator fed by the sharded query path; its :meth:`BucketStats.snapshot`
schema is the input contract for the cost-based planner (the same schema
as the JAX package's ``repro.obs.metrics.BucketStats``).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Optional

__all__ = ["H2D_SITES", "NULL_METRIC", "NULL_REGISTRY", "SUBBUCKETS",
           "BucketStats", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "StreamObs", "count_h2d", "json_sanitize", "prometheus_text"]

SUBBUCKETS = 4                   # histogram buckets per octave (see above)
_V0 = 1e-6                       # smallest resolvable histogram value
_LOG2_V0 = math.log2(_V0)


class _NullMetric:
    """Shared no-op stand-in for every metric type (disabled registry)."""

    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        """No-op counter increment."""

    def set(self, value: float) -> None:
        """No-op gauge assignment."""

    def observe(self, value: float) -> None:
        """No-op histogram observation."""


NULL_METRIC = _NullMetric()


class Counter:
    """Monotone named count (thread-safe)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        """Add ``n`` (default 1) to the count."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current count."""
        return self._value

    def snapshot(self):
        """JSON-safe value (int when integral)."""
        v = self._value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins named level (thread-safe enough: one float slot)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        """Record the current level."""
        self._value = float(value)

    def inc(self, n: float = 1) -> None:
        """Adjust the level by ``n`` (for resource-held style gauges)."""
        self._value += n

    @property
    def value(self) -> float:
        """Current level."""
        return self._value

    def snapshot(self) -> float:
        """JSON-safe value (non-finite levels become None)."""
        return self._value if math.isfinite(self._value) else None


class Histogram:
    """Log-bucketed distribution with p50/p95/p99 snapshots (thread-safe).

    Bucket index for a value ``v > V0`` is
    ``ceil(SUBBUCKETS * log2(v / V0))``; values at or below ``V0``
    (including 0) land in a dedicated underflow bucket.  A reported
    percentile is the containing bucket's upper edge clamped into
    ``[min, max]``, so it is always >= the true percentile and at most
    ``2**(1/SUBBUCKETS)`` times it (the property ``tests/test_obs.py``
    checks).
    """

    __slots__ = ("name", "_lock", "_buckets", "_under", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._under = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        """Record one observation."""
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if v <= _V0:
                self._under += 1
            else:
                idx = math.ceil(SUBBUCKETS * (math.log2(v) - _LOG2_V0))
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def count(self) -> int:
        """Number of observations."""
        return self._count

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``0 < q <= 1``); None when empty.

        Returns the upper edge of the bucket holding the ``ceil(q*n)``-th
        smallest observation, clamped into ``[min, max]``.
        """
        with self._lock:
            if self._count == 0:
                return None
            rank = max(math.ceil(q * self._count), 1)
            if rank <= self._under:
                return max(min(_V0, self._max), self._min)
            seen = self._under
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if seen >= rank:
                    edge = 2.0 ** (idx / SUBBUCKETS + _LOG2_V0)
                    return max(min(edge, self._max), self._min)
            return self._max               # pragma: no cover - defensive

    def snapshot(self) -> dict:
        """JSON-safe summary: count/sum/min/max + p50/p95/p99."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "p50": None, "p95": None, "p99": None}
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        return {"count": count, "sum": total, "min": lo, "max": hi,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Named-metric factory + snapshot/export surface.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create by name
    (thread-safe); a disabled registry returns :data:`NULL_METRIC` for
    everything and snapshots empty.  Metric names may carry a Prometheus
    label suffix (``'pack_bucket_rows{cap="512"}'``) which the text
    exposition keeps verbatim.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table, cls, name):
        if not self.enabled:
            return NULL_METRIC
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.setdefault(name, cls(name))
        return m

    def counter(self, name: str) -> Counter:
        """Get-or-create the named counter."""
        return self._get(self._counters, Counter, name)

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the named gauge."""
        return self._get(self._gauges, Gauge, name)

    def histogram(self, name: str) -> Histogram:
        """Get-or-create the named histogram."""
        return self._get(self._histograms, Histogram, name)

    def drop_prefix(self, prefix: str) -> None:
        """Forget metrics whose name starts with ``prefix`` — used for
        families whose member set shrinks (per-bucket occupancy gauges
        after a capacity class is released)."""
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                for name in [n for n in table if n.startswith(prefix)]:
                    del table[name]

    def snapshot(self) -> dict:
        """JSON-safe ``{counters, gauges, histograms}`` dump."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.snapshot() for n, c in sorted(counters.items())},
            "gauges": {n: g.snapshot() for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(histograms.items())},
        }

    def prometheus_text(self, prefix: str = "cubegraph") -> str:
        """Render the current state as Prometheus text exposition."""
        return prometheus_text(self.snapshot(), prefix=prefix)


NULL_REGISTRY = MetricsRegistry(enabled=False)

# Where the query path copies host arrays to its device, the label of
# ``h2d_bytes_total``: the sealed scan's (and traversal's) queries, the
# int8 rerank's queries and looked-up fp32 rows, the delta scan (queries,
# frozen rows, metadata), a cold bucket's blocks, and the rest (active
# masks, rerank positions, filter parameters, traversal seeds, a mesh's
# row order).  Each copy is counted where it is made, from the array
# copied.
H2D_SITES = ("scan_queries", "rerank_queries", "rerank_rows", "delta",
             "cold_stage", "other")
_H2D_NAMES = {s: f'h2d_bytes_total{{site="{s}"}}' for s in H2D_SITES}


def count_h2d(registry: MetricsRegistry, site: str, nbytes: int) -> None:
    """Add ``nbytes`` to ``h2d_bytes_total{site=...}``: counted where the
    copy is made, whatever the device's type (a CPU "copy" counts what a
    card would receive)."""
    registry.counter(_H2D_NAMES[site]).inc(int(nbytes))


class BucketStats:
    """Rolling per-capacity-bucket observations from the sharded read path.

    One :meth:`observe` call records one (query batch, capacity bucket)
    encounter.  The :meth:`snapshot` schema is the planner input
    contract (scan-vs-traversal cost model): per bucket capacity it
    reports, cumulatively,

    * ``queries`` — batches that considered the bucket,
    * ``dispatches`` — batches that actually launched its kernel,
    * ``rows`` / ``blocks_pruned`` — allocated shard rows seen vs rows
      skipped by whole-block temporal pruning; ``pruning_rate`` is their
      ratio (the temporal-pruning history term),
    * ``rows_scanned`` — padded kernel work actually dispatched
      (active rows × capacity — what a scan-cost term must charge),
    * ``candidates`` / ``candidate_slots`` — returned top-k entries that
      passed the filter vs list capacity; ``selectivity`` is their
      ratio, a *censored* observation of true filter selectivity (exact
      when the bucket under-fills its lists, a lower bound once they
      saturate),
    * ``cache_hits`` / ``cache_misses`` — dispatches that reused a
      compiled kernel vs forced a trace.
    """

    _COUNTS = ("queries", "dispatches", "rows", "blocks_pruned",
               "rows_scanned", "candidates", "candidate_slots",
               "cache_hits", "cache_misses")

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[int, Dict[str, int]] = {}

    def observe(self, cap: int, rows: int, active_rows: int,
                candidates: int = 0, candidate_slots: int = 0,
                cache_hit: Optional[bool] = None) -> None:
        """Record one query batch's encounter with one capacity bucket."""
        with self._lock:
            d = self._buckets.get(cap)
            if d is None:
                d = self._buckets[cap] = dict.fromkeys(self._COUNTS, 0)
            d["queries"] += 1
            d["rows"] += rows
            d["blocks_pruned"] += rows - active_rows
            if active_rows:
                d["dispatches"] += 1
                d["rows_scanned"] += active_rows * cap
                d["candidates"] += candidates
                d["candidate_slots"] += candidate_slots
                if cache_hit is not None:
                    d["cache_hits" if cache_hit else "cache_misses"] += 1

    def snapshot(self) -> Dict[str, dict]:
        """``{str(cap): {counts..., pruning_rate, selectivity}}`` —
        JSON-safe; rates are None until their denominator is non-zero."""
        with self._lock:
            buckets = {cap: dict(d) for cap, d in self._buckets.items()}
        out: Dict[str, dict] = {}
        for cap in sorted(buckets):
            d = buckets[cap]
            d["pruning_rate"] = (round(d["blocks_pruned"] / d["rows"], 4)
                                 if d["rows"] else None)
            d["selectivity"] = (round(d["candidates"]
                                      / d["candidate_slots"], 4)
                                if d["candidate_slots"] else None)
            out[str(cap)] = d
        return out


class StreamObs:
    """One manager's observability state: registry + bucket accumulator.

    Disabled (``StreamConfig(obs_enabled=False)``) both collapse to the
    shared no-op singletons, so the query/write paths stay allocation-free.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.registry = MetricsRegistry(enabled=enabled)
        self.bucket_stats = BucketStats() if enabled else None

    def snapshot(self) -> dict:
        """JSON-safe ``{enabled, metrics, buckets}`` export."""
        return {
            "enabled": self.enabled,
            "metrics": self.registry.snapshot(),
            "buckets": (self.bucket_stats.snapshot()
                        if self.bucket_stats is not None else {}),
        }


def json_sanitize(obj):
    """Deep-copy ``obj`` into strict-JSON territory.

    Applies the persistence layer's inf→null convention to every float
    (NaN included), converts numpy scalars/arrays to python scalars/lists,
    tuples to lists, and non-string dict keys to strings — the guarantee
    ``json.dumps(..., allow_nan=False)`` needs, end-to-end.
    """
    if isinstance(obj, dict):
        return {str(k): json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, int):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if hasattr(obj, "item") and getattr(obj, "ndim", 0) == 0:
        return json_sanitize(obj.item())  # numpy scalar
    if hasattr(obj, "tolist"):            # numpy array
        return json_sanitize(obj.tolist())
    return obj


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(prefix: str, name: str):
    """Split a registry name into (sanitized metric name, label suffix)."""
    base, labels = name, ""
    if "{" in name:
        base, rest = name.split("{", 1)
        labels = "{" + rest
    base = _NAME_RE.sub("_", f"{prefix}_{base}" if prefix else base)
    return base, labels


def prometheus_text(snapshot: dict, prefix: str = "cubegraph") -> str:
    """Render a :meth:`MetricsRegistry.snapshot` (or the ``metrics`` block
    of a ``metrics_snapshot()`` export) as Prometheus text exposition.

    Histograms are exposed as summaries (``quantile`` labels + ``_sum`` /
    ``_count``); non-finite and empty values are omitted, never emitted.
    """
    lines = []
    for name, value in snapshot.get("counters", {}).items():
        base, labels = _prom_name(prefix, name)
        lines.append(f"# TYPE {base} counter")
        lines.append(f"{base}{labels} {value}")
    for name, value in snapshot.get("gauges", {}).items():
        if value is None:
            continue
        base, labels = _prom_name(prefix, name)
        lines.append(f"# TYPE {base} gauge")
        lines.append(f"{base}{labels} {value}")
    for name, h in snapshot.get("histograms", {}).items():
        base, labels = _prom_name(prefix, name)
        inner = labels[1:-1] if labels else ""
        lines.append(f"# TYPE {base} summary")
        for q in ("p50", "p95", "p99"):
            if h.get(q) is not None:
                lab = f'quantile="0.{q[1:]}"'
                lab = "{" + (inner + "," if inner else "") + lab + "}"
                lines.append(f"{base}{lab} {h[q]}")
        lines.append(f"{base}_sum{labels} {h.get('sum', 0.0)}")
        lines.append(f"{base}_count{labels} {h.get('count', 0)}")
    return "\n".join(lines) + ("\n" if lines else "")
