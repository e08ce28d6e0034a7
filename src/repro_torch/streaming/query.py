"""Unified query path over the delta buffer and sealed segments.

Planning prunes segments whose ``[t_min, t_max]`` span misses the filter's
temporal bounds (extracted from its bounding box — half-open
``IntervalFilter`` windows work directly).  The query then fans out to the
delta buffer (exact fused-kernel scan) and the sealed segments — either one
stitched-graph beam search per segment (default) or, with
``StreamConfig.n_shards >= 1``, one kernel launch per non-empty,
temporally unpruned capacity *bucket* of the manager's size-bucketed shard
pack (temporal pruning skips whole device blocks).

Merging is a direct exact merge of the per-segment ``(gid, dist)`` pairs:
every path reports the same fp32 distance for the same point and global ids
are disjoint across the delta buffer and segments, so concatenating the
candidate lists and taking the global top-k needs no re-rank.  The merged
result is finally filtered through the manager's liveness bitmap, which is
what makes query results immune to racing deletions/compactions.

With ``StreamConfig(quantize="int8")`` the sealed-pack scan is two-stage:
the per-bucket launches run kernel B3 over int8 codes and over-fetch
``rerank_multiple * k`` candidates, which are reranked exactly at fp32
(``repro_torch.quant.rerank``) before entering the same merge.

With ``read_path="auto"|"graph"`` each sealed-pack dispatch first runs the
cost planner (``repro_torch.streaming.planner``): buckets planned ``scan``
go through the exact same kernel calls as above, buckets planned ``graph``
run the stitched beam traversal (``repro_torch.kernels.graph_topk``,
kernel B4 per hop) seeded with the entry points of every temporally
unpruned segment in the bucket.  fp32 graph blocks carry exact distances
and join the merge directly; quantized graph blocks go through the same
exact fp32 rerank.

With ``StreamConfig(device_budget_bytes=...)`` some buckets are cold
(their blocks in page-locked host memory): each query feeds its time
window to the tier's prefetch predictor, every cold dispatch counts one
``tier_miss_total``, buckets the planner prices ``admit_cheaper`` are
admitted for this very query, and a deadline refuses cold modes it cannot
pay for (mode ``skip``, a degraded answer).  An admission that fails
leaves the bucket cold: the query dispatches the cold view, exactly, and
the error lands in ``stats()["health"]``.

:func:`query_segments_grouped` (continuous filtered batching) answers
several :class:`GroupQuery` request groups in one pass: one snapshot, and
per sealed bucket one kernel launch per filter class over the bucket's
block, shared by every group active there — bit for bit the per-group
:func:`query_segments` answers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from ..core import Filter
from ..distributed.segment_shards import host_topk
from ..obs.metrics import NULL_REGISTRY
from ..obs.trace import NULL_TRACE, block_ready
from .resilience import Deadline, FaultError, QueryResult
from .segments import SegmentQueryStats

__all__ = ["host_topk", "merge_topk", "temporal_bounds", "query_segments",
           "GroupQuery", "query_segments_grouped"]


def temporal_bounds(filt: Optional[Filter], time_dim: int
                    ) -> Tuple[float, float]:
    """Filter -> (t_lo, t_hi) constraint on the time dim; ±inf if none."""
    if filt is None:
        return -np.inf, np.inf
    lo, hi = filt.bounding_box()
    if time_dim >= len(lo):
        return -np.inf, np.inf
    return float(lo[time_dim]), float(hi[time_dim])


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


def _plan_pack(manager, pack, filt, rp, t_lo, t_hi, obs, registry,
               deadline=None):
    """Run the cost planner over one ``PackView`` dispatch.

    Returns ``(plan, graph_caps)`` where ``graph_caps`` is the set of bucket
    capacities routed to the stitched traversal this dispatch.  Records
    the plan on ``manager.last_plan`` and bumps the
    ``planner_decision_total{mode=...}`` counters — one per bucket.  With
    a running ``deadline`` the remaining budget (in cost units, via
    ``PlannerCosts.cost_per_ms``) gates the cold modes: a ``host_scan`` /
    ``admit_cheaper`` it cannot cover becomes mode ``"skip"``.
    """
    from ..kernels.ops import encode_filter
    from .planner import PlannerCosts, plan_read_paths
    costs = manager.cfg.planner_costs or PlannerCosts()
    snap = (obs.bucket_stats.snapshot()
            if obs is not None and obs.bucket_stats is not None else {})
    # the traversal kernel reads the same packed predicate as the scan
    # kernels: a filter without an encoding forces scan everywhere
    graph_ok = encode_filter(filt, pack.m) is not None
    deadline_cost = (None if deadline is None else
                     max(deadline.remaining_ms(), 0.0) * costs.cost_per_ms)
    plan = plan_read_paths(pack, rp, snap, costs, t_lo, t_hi,
                           graph_allowed=graph_ok,
                           deadline_cost=deadline_cost)
    manager.last_plan = plan
    for dec in plan.values():
        registry.counter(
            f'planner_decision_total{{mode="{dec.mode}"}}').inc()
    graph_caps = frozenset(c for c, dec in plan.items()
                           if dec.mode == "graph")
    return plan, graph_caps


def _scan_buckets(manager, pack, queries, filt, k, t_lo, t_hi, metric,
                  trace, observe, on_cold=None, registry=NULL_REGISTRY):
    """Scan a ``PackView``: exact blocks for fp32 buckets, one reranked
    block for quantized ones; cold buckets stream through the same
    kernels (``on_cold`` counts them).  Returns ``(blocks_g,
    blocks_d)``."""
    from ..distributed.segment_shards import pack_search, pack_search_blocks
    if not pack.buckets:
        return [], []
    if pack.quantize is not None:
        # two-stage: over-fetch rerank_multiple * k from every unpruned
        # bucket's int8 launch, rerank the union exactly at fp32
        gg, dd = pack_search(pack, queries, filt, k, t_lo=t_lo, t_hi=t_hi,
                             metric=metric, lookup=manager.get_points,
                             rerank_multiple=manager.cfg.rerank_multiple,
                             trace=trace, observe=observe, on_cold=on_cold,
                             registry=registry)
        return [gg], [dd]
    out = pack_search_blocks(pack, queries, filt, k, t_lo=t_lo, t_hi=t_hi,
                             metric=metric, trace=trace, observe=observe,
                             on_cold=on_cold, registry=registry)
    return [g for g, _ in out], [d for _, d in out]


def _graph_search_blocks(manager, pack, buckets, queries, filt, k,
                         t_lo, t_hi, metric, trace, registry,
                         observe=None, on_cold=None, deadline=None,
                         degrade=None):
    """Stitched-traversal dispatch for the buckets the planner sent to
    ``graph`` mode.

    fp32 buckets yield exact ``(gid, dist)`` blocks; quantized buckets
    yield over-fetched candidate blocks that are reranked exactly at fp32
    (union across graph buckets — gids are disjoint) before joining the
    merge.  A bucket whose traversal is unavailable after all falls back
    to the ordinary scan for that bucket alone, feeding ``observe`` and
    ``on_cold`` like the main scan path.  A cold bucket (forced graph) is
    copied to the device for its traversal (``stage_bucket``), so B4 reads
    the bytes it would read resident.  With a running ``deadline`` the
    budget is checked
    before each bucket's traversal; once spent, the remaining buckets are
    skipped and reported through ``degrade("deadline_graph", n)``.
    Returns ``(blocks_g, blocks_d)``.
    """
    from ..distributed.segment_shards import bucket_graph_seeds, stage_bucket
    from ..kernels.graph_topk import bucket_graph_topk
    cfg = manager.cfg
    quantized = pack.quantize is not None
    kk = max(k, cfg.rerank_multiple * k if quantized else k)
    blocks_g: List[np.ndarray] = []
    blocks_d: List[np.ndarray] = []
    cand_g: List[np.ndarray] = []
    for i, bv in enumerate(buckets):
        if deadline is not None and deadline.expired():
            if degrade is not None:
                degrade("deadline_graph", len(buckets) - i)
            break
        seeds = bucket_graph_seeds(bv, t_lo, t_hi)
        with trace.span("bucket_graph", cap=bv.cap, seeds=int(len(seeds))):
            out = bucket_graph_topk(
                queries, stage_bucket(bv, pack.device, registry), seeds,
                filt, kk, m=pack.m, metric=metric, ef=max(cfg.graph_ef, kk),
                width=cfg.graph_width, max_iters=cfg.graph_max_iters,
                registry=registry)
        if out is None:                       # planner gate raced/failed
            sub = dataclasses.replace(pack, buckets=(bv,))
            gg, dd = _scan_buckets(manager, sub, queries, filt, k, t_lo,
                                   t_hi, metric, trace, observe, on_cold,
                                   registry)
            blocks_g.extend(gg)
            blocks_d.extend(dd)
            continue
        gg, dd, hops = out
        registry.histogram("graph_hops").observe(float(hops))
        if quantized:
            cand_g.append(gg)
        else:
            blocks_g.append(gg)
            blocks_d.append(dd)
    if cand_g:
        from ..quant.rerank import rerank_exact
        with trace.span("graph_rerank",
                        candidates=int(sum(g.shape[1] for g in cand_g))):
            gg, dd = rerank_exact(queries, np.concatenate(cand_g, axis=1),
                                  k, manager.get_points, metric=metric,
                                  device=manager.device, trace=trace,
                                  registry=registry)
        blocks_g.append(gg)
        blocks_d.append(dd)
    return blocks_g, blocks_d


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
    appear with ``pruned=True`` and zero search time; under the sharded
    path every searched segment reports the shared dispatch time).

    ``use_shards`` overrides ``StreamConfig.n_shards`` per call (True
    forces the sharded kernel scan, False the per-segment graph search).
    ``read_path`` overrides ``StreamConfig.read_path`` per call
    (``"scan"`` | ``"graph"`` | ``"auto"``): anything but ``"scan"`` runs
    the cost planner over the sealed pack and routes each bucket to the
    fused scan or the stitched traversal; the plan is left on
    ``manager.last_plan``.

    Timings and trace spans stop their clocks only after the device work
    they cover has finished.  ``deadline_ms`` (default
    ``StreamConfig.query_deadline_ms``; None = unbounded) is checked
    between bucket dispatches, graph traversals and segment searches;
    once spent, the remaining ones are skipped and the merged partial
    result comes back as a :class:`~.resilience.QueryResult` with
    ``degraded=True``.  The delta buffer is always scanned.
    """
    rp = manager.cfg.read_path if read_path is None else str(read_path)
    if rp not in ("scan", "graph", "auto"):
        raise ValueError(f"unknown read_path {rp!r}; supported: 'scan' | "
                         "'graph' | 'auto'")
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
    observe = (obs.bucket_stats.observe
               if obs is not None and obs.bucket_stats is not None else None)
    t_lo, t_hi = temporal_bounds(filt, manager.time_dim)
    metric = manager.cfg.index_cfg.metric
    # one lock hold captures the whole consistent view: the segment list
    # (epoch guard) AND a frozen copy of the delta's live rows
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
                ids, dd = delta.query(queries, filt, k, metric=metric,
                                      registry=registry)
                block_ready((ids, dd))
                st.search_ms = (time.perf_counter() - t0) * 1e3
            blocks_g.append(ids)
            blocks_d.append(dd)
        else:
            st.pruned = True
        stats.append(st)

    sharded = (manager.cfg.n_shards >= 1 if use_shards is None
               else bool(use_shards))
    live_segs = [g for g in segments if g.n_live > 0]
    if sharded and live_segs:
        from ..distributed.segment_shards import PackView, pack_search
        # None when every snapshot segment lost its last live point to a
        # racing delete — nothing sealed to search
        pack = manager.shard_pack(epoch, live_segs)
        dt_ms = 0.0
        tier = getattr(manager, "tier", None)
        on_cold = None
        if pack is not None:
            # cost-based routing: with read_path != "scan" the planner
            # splits the buckets into a scan subset (the exact same calls
            # as forced scan) and a graph subset (stitched traversal)
            scan_pack = pack
            graph_bvs: tuple = ()
            if tier is not None and isinstance(pack, PackView):
                # feed the window's drift to the prefetch predictor and
                # count cold (streamed) dispatches as tier misses
                tier.note_window(t_lo, t_hi)

                def on_cold(cap, stage_bytes, _reg=registry):
                    _reg.counter("tier_miss_total").inc()
            if isinstance(pack, PackView) and rp != "scan":
                plan, graph_caps = _plan_pack(manager, pack, filt, rp, t_lo,
                                              t_hi, obs, registry,
                                              deadline=deadline)
                # deadline-refused buckets: every cold route costs more
                # than the budget left — omit them, answer degraded
                skip_caps = frozenset(c for c, dec in plan.items()
                                      if dec.mode == "skip")
                if skip_caps:
                    _degrade("deadline_planner", len(skip_caps))
                if tier is not None:
                    # the planner priced re-admission below streaming:
                    # admit now and dispatch the resident block in this
                    # very query (tier_admit returns None — keep the exact
                    # cold view — when the block no longer fits or the
                    # pack moved past this query's epoch)
                    admitted = {}
                    for cap, dec in plan.items():
                        if dec.reason == "admit_cheaper":
                            try:
                                nbv = manager.tier_admit(cap,
                                                         expect_epoch=epoch)
                            except FaultError as exc:
                                # an injected crash: the bucket stays
                                # cold; dispatch the exact cold view and
                                # record the failure
                                manager.supervisor.note_error(
                                    "tier_admission", exc)
                                continue
                            if nbv is not None:
                                admitted[cap] = nbv
                    if admitted:
                        pack = dataclasses.replace(
                            pack, buckets=tuple(admitted.get(bv.cap, bv)
                                                for bv in pack.buckets))
                        scan_pack = pack
                drop = graph_caps | skip_caps
                if drop:
                    graph_bvs = tuple(bv for bv in pack.buckets
                                      if bv.cap in graph_caps)
                    scan_pack = dataclasses.replace(
                        pack, buckets=tuple(bv for bv in pack.buckets
                                            if bv.cap not in drop))
            with trace.span("sealed_scan",
                            quantized=getattr(pack, "quantize", None)
                            is not None):
                t0 = time.perf_counter()
                if isinstance(pack, PackView) and deadline is not None:
                    # deadline-aware dispatch: one sub-view per bucket so
                    # the budget is re-checked between bucket launches.
                    # Per-bucket exact (or reranked-to-k) blocks merge to
                    # the same (dist, gid) answer as the bulk dispatch,
                    # so a query that finishes in time is bit-for-bit the
                    # no-deadline answer.
                    bvs = scan_pack.buckets
                    for i, bv in enumerate(bvs):
                        if deadline.expired():
                            _degrade("deadline_sealed_scan", len(bvs) - i)
                            break
                        manager._fault("query.bucket")
                        sub = dataclasses.replace(scan_pack, buckets=(bv,))
                        gg, dd = _scan_buckets(manager, sub, queries, filt,
                                               k, t_lo, t_hi, metric, trace,
                                               observe, on_cold, registry)
                        blocks_g.extend(gg)
                        blocks_d.extend(dd)
                elif isinstance(pack, PackView):
                    gg, dd = _scan_buckets(manager, scan_pack, queries, filt,
                                           k, t_lo, t_hi, metric, trace,
                                           observe, on_cold, registry)
                    blocks_g.extend(gg)
                    blocks_d.extend(dd)
                else:                     # monolithic pack
                    gg, dd = pack_search(pack, queries, filt, k, t_lo=t_lo,
                                         t_hi=t_hi, metric=metric,
                                         trace=trace, registry=registry)
                    blocks_g.append(gg)
                    blocks_d.append(dd)
                if graph_bvs:
                    gb_g, gb_d = _graph_search_blocks(
                        manager, pack, graph_bvs, queries, filt, k,
                        t_lo, t_hi, metric, trace, registry,
                        observe=observe, on_cold=on_cold, deadline=deadline,
                        degrade=_degrade)
                    blocks_g.extend(gb_g)
                    blocks_d.extend(gb_d)
                dt_ms = (time.perf_counter() - t0) * 1e3
            if tier is not None:
                # stage buckets the window's drift is about to reach, off
                # the query path (a supervised thread, at most one)
                manager.maybe_prefetch()
        for seg in segments:
            st = seg.stats()
            if pack is None or seg.n_live == 0 \
                    or not seg.overlaps(t_lo, t_hi):
                st.pruned = True
            else:
                st.search_ms = dt_ms
            stats.append(st)
    else:
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
            with trace.span("segment_scan", seg_id=seg.seg_id,
                            rows=seg.n_live):
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
        with trace.span("merge_topk"):
            out_g, out_d = merge_topk(blocks_g, blocks_d, k)
        with trace.span("alive_filter"):
            out_g, out_d = _alive_filter(manager, out_g, out_d)
    registry.histogram("query_ms").observe(
        (time.perf_counter() - t_all) * 1e3)
    out = (out_g, out_d, stats) if return_stats else (out_g, out_d)
    return QueryResult(out, degraded=bool(reasons), reasons=reasons)


@dataclasses.dataclass
class GroupQuery:
    """One request group of a heterogeneous batched query: its own query
    rows, filter, ``k`` and per-call overrides (deadline, read path) — the
    unit :func:`query_segments_grouped` batches into shared per-bucket
    dispatches."""

    queries: np.ndarray
    filt: Optional[Filter] = None
    k: int = 10
    ef: int = 64
    deadline_ms: Optional[float] = None
    read_path: Optional[str] = None


def query_segments_grouped(manager, groups, trace=None, observe_group=None):
    """Continuous filtered batching: answer several heterogeneous
    :class:`GroupQuery` request groups in one pass over the manager's
    state — one snapshot, one delta scan per group, and one shared
    per-bucket sealed-pack dispatch in which every group active in a
    bucket reads the same device block
    (:func:`repro_torch.distributed.segment_shards.pack_search_blocks_grouped`:
    one B1 launch per filter class).

    Answers are bit for bit what per-group :func:`query_segments` calls
    return: each candidate's distance is computed the same way whatever
    the launch, a group's bucket skip set matches its solo temporal
    pruning, and each group merges with its own ``k`` and temporal mask
    through the same exact ``(dist, gid)`` merge.

    The shared fast path needs a bucketed fp32 pack (``n_shards >= 1``,
    ``incremental_pack``, ``quantize=None``) with every group on the
    ``"scan"`` read path; anything else falls back to per-group
    :func:`query_segments` calls — the same answers, no block sharing.

    Per-group deadlines (``GroupQuery.deadline_ms``, default
    ``StreamConfig.query_deadline_ms``) drop only the lagging group from
    the remaining buckets and mark its :class:`~.resilience.QueryResult`
    degraded with ``deadline_sealed_scan`` skip counts, as the solo path
    does.  ``observe_group(group_idx, cap, rows=, active_rows=,
    candidates=, candidate_slots=, cache_hit=)`` attributes each shared
    bucket dispatch to the groups that read it (per-tenant
    ``BucketStats``).  Returns one ``QueryResult((gids [b_i, k_i], dists
    [b_i, k_i]))`` per group, in input order.
    """
    trace = NULL_TRACE if trace is None else trace
    obs = getattr(manager, "obs", None)
    registry = obs.registry if obs is not None else NULL_REGISTRY
    cfg = manager.cfg
    groups = list(groups)
    if not groups:
        return []
    rps = [g.read_path if g.read_path is not None else cfg.read_path
           for g in groups]
    shared_ok = (cfg.n_shards >= 1 and cfg.incremental_pack
                 and cfg.quantize is None
                 and all(rp == "scan" for rp in rps))
    if not shared_ok:
        return [query_segments(manager, g.queries, g.filt, k=g.k, ef=g.ef,
                               trace=trace, read_path=g.read_path,
                               deadline_ms=g.deadline_ms)
                for g in groups]

    t_all = time.perf_counter()
    qs = [np.atleast_2d(np.asarray(g.queries, np.float32)) for g in groups]
    bounds = [temporal_bounds(g.filt, manager.time_dim) for g in groups]
    deadlines = [Deadline.start(g.deadline_ms if g.deadline_ms is not None
                                else cfg.query_deadline_ms) for g in groups]
    reasons: List[dict] = [{} for _ in groups]

    def _degrade(gi: int, reason: str, n: int = 1) -> None:
        reasons[gi][reason] = reasons[gi].get(reason, 0) + int(n)
        registry.counter(
            f'query_degraded_total{{reason="{reason}"}}').inc(n)

    observe = (obs.bucket_stats.observe
               if obs is not None and obs.bucket_stats is not None else None)
    metric = cfg.index_cfg.metric
    with trace.span("snapshot"):
        epoch, segments, delta = manager.snapshot()

    blocks_g: List[List[np.ndarray]] = [[] for _ in groups]
    blocks_d: List[List[np.ndarray]] = [[] for _ in groups]

    if delta.n_live > 0:
        for gi, (q, (t_lo, t_hi)) in enumerate(zip(qs, bounds)):
            if delta.t_max >= t_lo and delta.t_min <= t_hi:
                with trace.span("delta_scan", rows=delta.n_live, group=gi):
                    ids, dd = delta.query(q, groups[gi].filt, groups[gi].k,
                                          metric=metric, registry=registry)
                    block_ready((ids, dd))
                blocks_g[gi].append(ids)
                blocks_d[gi].append(dd)

    live_segs = [s for s in segments if s.n_live > 0]
    if live_segs:
        from ..distributed.segment_shards import (PackView,
                                                  pack_search_blocks_grouped)
        # None when every snapshot segment lost its last live point to a
        # racing delete — nothing sealed to search
        pack = manager.shard_pack(epoch, live_segs)
        if isinstance(pack, PackView):
            tier = getattr(manager, "tier", None)
            on_cold = None
            if tier is not None:
                for t_lo, t_hi in bounds:
                    tier.note_window(t_lo, t_hi)

                def on_cold(cap, stage_bytes, _reg=registry):
                    _reg.counter("tier_miss_total").inc()
            pk_groups = [(qs[gi], groups[gi].filt, groups[gi].k,
                          bounds[gi][0], bounds[gi][1])
                         for gi in range(len(groups))]
            with trace.span("sealed_scan_grouped", groups=len(groups)):
                per = pack_search_blocks_grouped(
                    pack, pk_groups, metric=metric, trace=trace,
                    observe=observe, on_cold=on_cold, deadlines=deadlines,
                    on_expired=lambda gi, n:
                        _degrade(gi, "deadline_sealed_scan", n),
                    fault=lambda: manager._fault("query.bucket"),
                    observe_group=observe_group, registry=registry)
            for gi, bl in enumerate(per):
                for gg, dd in bl:
                    blocks_g[gi].append(gg)
                    blocks_d[gi].append(dd)
            if tier is not None:
                manager.maybe_prefetch()

    out: List[QueryResult] = []
    for gi, g in enumerate(groups):
        b = qs[gi].shape[0]
        registry.counter("query_batches_total").inc()
        registry.counter("query_rows_total").inc(b)
        if reasons[gi]:
            registry.counter("query_degraded_queries_total").inc()
        if not blocks_g[gi]:
            og = np.full((b, g.k), -1, np.int64)
            od = np.full((b, g.k), np.inf, np.float32)
        else:
            with trace.span("merge", blocks=len(blocks_g[gi]), group=gi):
                with trace.span("merge_topk"):
                    og, od = merge_topk(blocks_g[gi], blocks_d[gi], g.k)
                with trace.span("alive_filter"):
                    og, od = _alive_filter(manager, og, od)
        out.append(QueryResult((og, od), degraded=bool(reasons[gi]),
                               reasons=reasons[gi]))
    registry.histogram("query_ms").observe(
        (time.perf_counter() - t_all) * 1e3)
    return out
