"""Statistics over the benchmark's own raw samples."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of every sample: the
    smallest value with at least ``q`` percent of the samples at or below
    it.  No interpolation, no buckets."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return float(ordered[rank - 1])


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return float(count) / seconds


def spread(values: Sequence[float]) -> float:
    """Quartile spread as a share of the median: ``(Q3 - Q1) / median``
    with ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
