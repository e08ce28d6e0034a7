"""What a traced run hands to the per-layer readers in ``metrics/``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .devtrace import DeviceTrace


@dataclasses.dataclass
class Readings:
    """One traced run's raw material.

    ``spans``: the program's span tree of every batch of the traced window
    (``QueryTrace.to_dict()``).  ``counters``: the program's counters,
    their change over the traced window.  ``trace``: the device trace of
    the traced window (None where the profiler saw no device).
    ``bound_s``: the filtered scan's least time over the traced window's
    batches (``peaks.scan_bound_s``).  ``window``: the
    untraced window's numbers (``qps``, ``p95_ms``, ``seconds``, ``ops``:
    the filtered scan's operations its batches needed).
    ``ingest_rows_per_s``: the set-up's ingest rate.
    """

    spans: List[dict]
    counters: Dict[str, float]
    trace: Optional[DeviceTrace]
    window: Dict[str, float]
    bound_s: float
    ingest_rows_per_s: float


def span_total_ms(node: dict, name: str) -> float:
    """Milliseconds of every span called ``name`` in one batch's tree."""
    own = node.get("ms", 0.0) if node.get("name") == name else 0.0
    return own + sum(span_total_ms(c, name) for c in node.get("spans", ()))


def ms_per_batch(r: Readings, name: str) -> Optional[float]:
    """Mean ms a batch spent in ``name`` spans; None where none ran."""
    totals = [span_total_ms(s, name) for s in r.spans]
    if not totals or not any(_has(s, name) for s in r.spans):
        return None
    return sum(totals) / len(totals)


def _has(node: dict, name: str) -> bool:
    return node.get("name") == name or any(_has(c, name)
                                           for c in node.get("spans", ()))
