"""Unified query path over the delta buffer and sealed segments.

Planning prunes segments whose ``[t_min, t_max]`` span misses the filter's
temporal bounds (extracted from its bounding box — half-open
``IntervalFilter`` windows work directly).  The query then fans out to the
delta buffer (exact fused-kernel scan) and to every unpruned sealed
segment (one stitched-graph beam search each).

Merging is a direct exact merge of the per-segment ``(gid, dist)`` pairs:
every path reports the same fp32 distance for the same point and global ids
are disjoint across the delta buffer and segments, so concatenating the
candidate lists and taking the global top-k needs no re-rank.  The merged
result is finally filtered through the manager's liveness bitmap, which is
what makes query results immune to racing deletions/compactions.

The sharded, quantized and graph read paths and the grouped (continuous
batching) entry point of the reference are not ported yet.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..core import Filter
from ..obs.metrics import NULL_REGISTRY
from ..obs.trace import NULL_TRACE, block_ready
from .resilience import Deadline, QueryResult
from .segments import SegmentQueryStats

__all__ = ["host_topk", "merge_topk", "temporal_bounds", "query_segments"]


def temporal_bounds(filt: Optional[Filter], time_dim: int
                    ) -> Tuple[float, float]:
    """Filter -> (t_lo, t_hi) constraint on the time dim; ±inf if none."""
    if filt is None:
        return -np.inf, np.inf
    lo, hi = filt.bounding_box()
    if time_dim >= len(lo):
        return -np.inf, np.inf
    return float(lo[time_dim]), float(hi[time_dim])


def host_topk(g: np.ndarray, d: np.ndarray, k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host-side top-k over concatenated ``(gid, dist)`` candidate
    rows: ``argpartition`` narrows each row to ``k`` candidates, then one
    ``lexsort`` orders the slice by ``(dist, gid)``.  Rows where a finite
    distance tie straddles the k-th position are re-selected by the full
    ``(dist, gid)`` order, so the result does not depend on block order.
    Returns ``(gids [b, k] int64, dists [b, k] fp32)`` padded with
    ``-1`` / ``+inf``."""
    d = np.where(g >= 0, np.asarray(d, np.float32), np.inf)
    g = np.asarray(g, np.int64)
    if d.shape[1] > k:
        part = np.argpartition(d, k - 1, axis=1)
        g_sel = np.take_along_axis(g, part[:, :k], axis=1)
        d_sel = np.take_along_axis(d, part[:, :k], axis=1)
        kth = d_sel.max(axis=1)
        d_rest = np.take_along_axis(d, part[:, k:], axis=1)
        # +inf boundary ties are harmless (every +inf selection emits
        # gid -1 below); finite ones get the rare full-sort path
        amb = np.isfinite(kth) & (d_rest == kth[:, None]).any(axis=1)
        if amb.any():
            full = np.lexsort((g[amb], d[amb]))[:, :k]
            g_sel[amb] = np.take_along_axis(g[amb], full, axis=1)
            d_sel[amb] = np.take_along_axis(d[amb], full, axis=1)
        g, d = g_sel, d_sel
    order = np.lexsort((g, d))           # per-row: dist, then gid
    out_g = np.take_along_axis(g, order, axis=1)
    out_d = np.take_along_axis(d, order, axis=1)
    out_g = np.where(np.isfinite(out_d), out_g, -1)
    if out_g.shape[1] < k:
        pad = k - out_g.shape[1]
        out_g = np.pad(out_g, ((0, 0), (0, pad)), constant_values=-1)
        out_d = np.pad(out_d, ((0, 0), (0, pad)), constant_values=np.inf)
    return out_g, out_d.astype(np.float32)


def merge_topk(blocks_g: List[np.ndarray], blocks_d: List[np.ndarray],
               k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k merge of per-segment ``(gid, dist)`` blocks.

    Blocks are ``[b, k_i]`` with ``-1`` id padding; distances are
    comparable across blocks (same metric over the same vectors), and gids
    are disjoint across blocks, so the top-k of the concatenation is the
    exact global answer, tie-broken on gid.  Returns ``(gids [b, k],
    dists [b, k])``.
    """
    return host_topk(np.concatenate(blocks_g, axis=1),
                     np.concatenate(blocks_d, axis=1), k)


def _alive_filter(manager, gids: np.ndarray, dists: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop merged candidates whose gid has since been deleted/expired,
    keeping each row's order and -1/inf padding."""
    ok = gids >= 0
    ok[ok] = manager.alive[gids[ok]]
    if ok.all():
        return gids, dists
    order = np.argsort(~ok, axis=1, kind="stable")
    gids = np.take_along_axis(np.where(ok, gids, -1), order, axis=1)
    dists = np.take_along_axis(np.where(ok, dists, np.inf), order, axis=1)
    return gids, dists


def query_segments(manager, queries: np.ndarray, filt: Optional[Filter],
                   k: int = 10, ef: int = 64, return_stats: bool = False,
                   use_shards: Optional[bool] = None, trace=None,
                   read_path: Optional[str] = None,
                   deadline_ms: Optional[float] = None,
                   **search_kw):
    """Fan out one query batch across all live segments and merge top-k.

    Runs against a snapshot — ``(epoch, segment list, frozen delta copy)``
    — taken under the manager lock at entry, so concurrent compaction
    publishes never tear the segment list mid-query and concurrent
    ingests/seals never mutate the delta rows being scanned.  Returns
    ``(gids [b, k], dists [b, k])`` — plus a list of per-segment
    ``SegmentQueryStats`` when ``return_stats`` is set (pruned segments
    appear with ``pruned=True`` and zero search time).

    ``use_shards=True`` and ``read_path`` other than ``"scan"`` select read
    paths that are not ported yet and raise ``NotImplementedError``.

    Timings and trace spans stop their clocks only after the device work
    they cover has finished.  ``deadline_ms`` (default
    ``StreamConfig.query_deadline_ms``; None = unbounded) is checked
    between segment searches; once spent, the remaining segments are
    skipped and the merged partial result comes back as a
    :class:`~.resilience.QueryResult` with ``degraded=True``.  The delta
    buffer is always scanned.
    """
    if use_shards:
        raise NotImplementedError(
            "the sharded sealed read path (n_shards >= 1) is not ported yet "
            "(ROADMAP Queue A item 5)")
    rp = manager.cfg.read_path if read_path is None else str(read_path)
    if rp != "scan":
        raise NotImplementedError(
            f"read_path={rp!r} (graph read path and planner) is not ported "
            "yet (ROADMAP Queue A item 7)")
    t_all = time.perf_counter()
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    b = queries.shape[0]
    trace = NULL_TRACE if trace is None else trace
    obs = getattr(manager, "obs", None)
    registry = obs.registry if obs is not None else NULL_REGISTRY
    if deadline_ms is None:
        deadline_ms = manager.cfg.query_deadline_ms
    deadline = Deadline.start(deadline_ms)
    reasons: dict = {}

    def _degrade(reason: str, n: int = 1) -> None:
        reasons[reason] = reasons.get(reason, 0) + int(n)
        registry.counter(
            f'query_degraded_total{{reason="{reason}"}}').inc(n)
    t_lo, t_hi = temporal_bounds(filt, manager.time_dim)
    metric = manager.cfg.index_cfg.metric
    with trace.span("snapshot"):
        epoch, segments, delta = manager.snapshot()

    blocks_g: List[np.ndarray] = []
    blocks_d: List[np.ndarray] = []
    stats: List[SegmentQueryStats] = []

    if delta.n_live > 0:
        st = delta.stats()
        if delta.t_max >= t_lo and delta.t_min <= t_hi:
            with trace.span("delta_scan", rows=delta.n_live):
                t0 = time.perf_counter()
                ids, dd = delta.query(queries, filt, k, metric=metric)
                block_ready((ids, dd))
                st.search_ms = (time.perf_counter() - t0) * 1e3
            blocks_g.append(ids)
            blocks_d.append(dd)
        else:
            st.pruned = True
        stats.append(st)

    for seg in segments:
        st = seg.stats()
        if seg.n_live == 0 or not seg.overlaps(t_lo, t_hi):
            st.pruned = True
            stats.append(st)
            continue
        if deadline is not None and deadline.expired():
            # budget spent: report the segment unsearched (pruned with
            # zero search time) and mark the answer degraded
            _degrade("deadline_segment")
            st.pruned = True
            stats.append(st)
            continue
        with trace.span("segment_scan", seg_id=seg.seg_id, rows=seg.n_live):
            t0 = time.perf_counter()
            ids, dd = seg.query(queries, filt, k=k, ef=ef, **search_kw)
            block_ready((ids, dd))
            st.search_ms = (time.perf_counter() - t0) * 1e3
        blocks_g.append(ids)
        blocks_d.append(np.asarray(dd))
        stats.append(st)

    registry.counter("query_batches_total").inc()
    registry.counter("query_rows_total").inc(b)
    if reasons:
        registry.counter("query_degraded_queries_total").inc()
    if not blocks_g:
        out_g = np.full((b, k), -1, np.int64)
        out_d = np.full((b, k), np.inf, np.float32)
        registry.histogram("query_ms").observe(
            (time.perf_counter() - t_all) * 1e3)
        out = (out_g, out_d, stats) if return_stats else (out_g, out_d)
        return QueryResult(out, degraded=bool(reasons), reasons=reasons)

    with trace.span("merge", blocks=len(blocks_g)):
        out_g, out_d = merge_topk(blocks_g, blocks_d, k)
        out_g, out_d = _alive_filter(manager, out_g, out_d)
    registry.histogram("query_ms").observe(
        (time.perf_counter() - t_all) * 1e3)
    out = (out_g, out_d, stats) if return_stats else (out_g, out_d)
    return QueryResult(out, degraded=bool(reasons), reasons=reasons)
