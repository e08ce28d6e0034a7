"""Tiered bucket storage: device memory as a budgeted cache over the
bucketed pack.

Residency is a *policy*: under ``StreamConfig(device_budget_bytes=...)``
the :class:`~repro_torch.distributed.segment_shards.BucketedShardPack`
keeps at most ``budget`` CUDA bytes of bucket blocks resident and demotes
the rest to page-locked host tensors (``BucketedShardPack.evict_bucket``).
On a shard mesh the budget is a total over every card, as the reference's
(a bucket's bytes are summed over its cards), and a tier miss counts the
bucket's bytes on all of them.
Three pieces:

* **Exactness for cold reads** — an evicted bucket's host block holds
  byte-identical content to the device block it replaced; a cold dispatch
  copies it into a transient device buffer and launches *the same kernel*
  (B1 / B3, or B4 for a traversal) at the same shapes.  Same kernel + same
  bytes ⇒ the ``(dist, gid)`` results are bit-for-bit the all-resident
  ones — the property ``tests/test_torch_tiering.py`` pins across
  lifecycle interleavings.
  :func:`host_reference_topk` is the independent numpy oracle for that
  contract (same ``(dist, gid)`` ordering as
  :func:`~repro_torch.distributed.segment_shards.host_topk`).

* **Admission/eviction policy** (host numpy, the reference's decisions
  exactly) — :class:`TierState` ranks buckets by
  *heat*: the rolling ``BucketStats`` dispatch history (buckets the
  planner keeps dispatching are hot) plus overlap with the recent query
  windows (buckets the workload's time range touches are hot even before
  their first dispatch).  ``pick_victims`` evicts coldest-first until the
  budget holds; the manager re-enforces after every pack delta
  (seal/publish/expire) and every admission.

* **Time-window prefetch** — :meth:`TierState.note_window` records each
  query's ``[t_lo, t_hi]``; :meth:`TierState.predicted_window` linearly
  extrapolates the windows' drift (mean successive center delta), and
  ``prefetch_targets`` names the cold buckets the *next* window will
  touch so ``SegmentManager.maybe_prefetch`` can stage them off the query
  path (same lock/epoch discipline as ``compact_async``) before queries
  land on them.

The planner's third mode (``host_scan`` in ``streaming/planner.py``)
prices cold dispatches against "admit first, then run resident"; this
module never decides *plans*, only *residency*.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed.segment_shards import PAD_META, host_topk

__all__ = ["TierState", "host_reference_topk"]

# Heat bonus for a bucket whose time span overlaps the recent/predicted
# query windows: dominates any realistic dispatch count so temporal
# relevance outranks stale popularity when picking eviction victims.
_WINDOW_BONUS = 1e9


class TierState:
    """Residency policy state for one :class:`SegmentManager` (thread-safe).

    Owns nothing but the budget number and the rolling query-window
    history; the pack holds the actual blocks and the manager serializes
    evict/admit calls under its lock.  ``registry`` is the obs metrics
    registry the tier gauges/counters go to (``NULL_REGISTRY`` when
    observability is off).
    """

    def __init__(self, budget_bytes: int, registry=None,
                 window_history: int = 12):
        from ..obs.metrics import NULL_REGISTRY
        self.budget_bytes = int(budget_bytes)
        self.registry = NULL_REGISTRY if registry is None else registry
        self._lock = threading.Lock()
        self._windows: collections.deque = collections.deque(
            maxlen=max(int(window_history), 2))

    # ------------------------------------------------------------------
    # query-window drift tracking

    def note_window(self, t_lo: float, t_hi: float) -> None:
        """Record one query's time window (ignored unless both ends are
        finite — unbounded scans say nothing about drift)."""
        if np.isfinite(t_lo) and np.isfinite(t_hi) and t_lo <= t_hi:
            with self._lock:
                self._windows.append((float(t_lo), float(t_hi)))

    def recent_window(self) -> Optional[Tuple[float, float]]:
        """The last finite query window, or None before any."""
        with self._lock:
            return self._windows[-1] if self._windows else None

    def predicted_window(self) -> Optional[Tuple[float, float]]:
        """Extrapolate where the workload's window lands next: the last
        window shifted by the mean successive center delta.  With fewer
        than two recorded windows the last one is returned unshifted
        (stationary workloads prefetch what they already touch)."""
        with self._lock:
            wins = list(self._windows)
        if not wins:
            return None
        lo, hi = wins[-1]
        if len(wins) == 1:
            return (lo, hi)
        centers = [(a + b) / 2.0 for a, b in wins]
        drift = float(np.mean(np.diff(centers)))
        return (lo + drift, hi + drift)

    # ------------------------------------------------------------------
    # heat + policy

    @staticmethod
    def _overlaps(t_min: float, t_max: float,
                  win: Optional[Tuple[float, float]]) -> bool:
        if win is None:
            return False
        return t_max >= win[0] and t_min <= win[1]

    def heat(self, meta: Dict) -> float:
        """One bucket's heat: rolling dispatch count plus a dominating
        bonus when its time span overlaps the recent or predicted query
        window.  ``meta`` is one row from ``SegmentManager._bucket_meta``
        (keys ``cap``/``resident``/``nbytes``/``t_min``/``t_max``/
        ``stats``)."""
        stats = meta.get("stats")
        h = float(stats["dispatches"]) if stats else 0.0
        recent = self.recent_window()
        predicted = self.predicted_window()
        if self._overlaps(meta["t_min"], meta["t_max"], recent) or \
                self._overlaps(meta["t_min"], meta["t_max"], predicted):
            h += _WINDOW_BONUS
        return h

    def pick_victims(self, meta: Sequence[Dict],
                     need_bytes: int) -> List[int]:
        """Capacities to evict, coldest-first, until ``need_bytes`` of
        device memory frees up.  Ties (no observations, no window
        overlap) break toward evicting the bucket with the *oldest*
        ``t_max`` (furthest from the workload's drift) and, below that,
        the largest block (fewest evictions)."""
        resident = [m for m in meta if m["resident"] and m["nbytes"] > 0]
        resident.sort(key=lambda m: (self.heat(m), m["t_max"],
                                     -m["nbytes"]))
        victims, freed = [], 0
        for m in resident:
            if freed >= need_bytes:
                break
            victims.append(m["cap"])
            freed += m["nbytes"]
        return victims

    def prefetch_targets(self, meta: Sequence[Dict]) -> List[int]:
        """Cold buckets whose time span overlaps the predicted next
        window, hottest-first — what the prefetcher should stage before
        queries land on them.  Empty before any finite window."""
        win = self.predicted_window()
        if win is None:
            return []
        cold = [m for m in meta
                if not m["resident"]
                and self._overlaps(m["t_min"], m["t_max"], win)]
        cold.sort(key=lambda m: -self.heat(m))
        return [m["cap"] for m in cold]


def host_reference_topk(bv, queries: np.ndarray, filt, k: int,
                        t_lo: float, t_hi: float, metric: str = "l2",
                        m: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Independent pure-numpy oracle for one fp32 bucket's filtered top-k.

    Documents (and lets tests pin) the cold-read exactness contract: the
    same validity rules as the fused kernel (pad rows rejected via the
    ``PAD_META`` sentinel, temporally pruned rows dropped, φ evaluated on
    the first ``m`` metadata dims) and the same ``(dist, gid)`` total
    order (delegates the final merge to
    :func:`~repro_torch.distributed.segment_shards.host_topk`).  ``bv``
    may be resident or cold, on one device or a shard mesh: its blocks are
    read back to the host in global row order.  Distances are
    numerically — not bitwise — the kernel's (different accumulation
    order), so comparisons use ``allclose`` on distances and exact
    equality on gids away from ties.  Quantized buckets have no single
    host-side distance (asymmetric + rerank), so this oracle rejects
    them.
    """
    if bv.quantized:
        raise ValueError("host_reference_topk covers fp32 buckets only")
    q = np.asarray(queries, np.float32)
    x = bv.block("x").cpu().numpy()           # [rows, cap, d]
    s = bv.block("s").cpu().numpy()           # [rows, cap, m]
    g = bv.block("gids").cpu().numpy().astype(np.int64)  # [rows, cap]
    rows, cap, d = x.shape
    xf = x.reshape(rows * cap, d)
    sf = s.reshape(rows * cap, -1)
    gf = g.reshape(rows * cap)
    active = bv.active_rows(t_lo, t_hi)
    valid = (gf >= 0) & np.repeat(active, cap) & (sf[:, 0] < PAD_META / 2)
    if filt is not None:
        mm = sf.shape[1] if m is None else int(m)
        valid = valid & filt.contains(sf[:, :mm]).cpu().numpy()
    if metric == "l2":
        qq = (q ** 2).sum(-1, dtype=np.float32)
        xx = (xf ** 2).sum(-1, dtype=np.float32)
        d = qq[:, None] - 2.0 * (q @ xf.T) + xx[None, :]
    elif metric == "ip":
        d = -(q @ xf.T)
    else:
        raise ValueError(f"unknown metric: {metric!r}")
    gmat = np.broadcast_to(gf, (q.shape[0], gf.size)).copy()
    gmat[:, ~valid] = -1
    return host_topk(gmat, d.astype(np.float32), k)
