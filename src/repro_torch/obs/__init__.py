"""Observability substrate: metrics registry, query tracer, bucket stats.

* :mod:`repro_torch.obs.metrics` — named counters, gauges, and
  log-bucketed latency histograms behind a thread-safe
  :class:`MetricsRegistry`; the per-capacity-bucket :class:`BucketStats`
  accumulator; Prometheus text rendering and a strict-JSON sanitizer
  shared with ``SegmentManager.stats()``.
* :mod:`repro_torch.obs.trace` — per-query :class:`QueryTrace` span trees
  whose timers stop only after the CUDA work they cover has finished, and
  which annotate ``torch.profiler`` traces.

Disabled instances (``MetricsRegistry(enabled=False)``, ``NULL_TRACE``)
hand out shared no-op singletons.
"""
from .metrics import (NULL_METRIC, NULL_REGISTRY, BucketStats, Counter,
                      Gauge, Histogram, MetricsRegistry, StreamObs,
                      json_sanitize, prometheus_text)
from .trace import NULL_TRACE, QueryTrace, Span, block_ready

__all__ = ["NULL_METRIC", "NULL_REGISTRY", "NULL_TRACE", "BucketStats",
           "Counter", "Gauge", "Histogram", "MetricsRegistry", "QueryTrace",
           "Span", "StreamObs", "block_ready", "json_sanitize",
           "prometheus_text"]
