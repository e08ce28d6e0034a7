"""Cost-based read-path planner: scan vs. stitched graph traversal.

The sealed-segment read path has three per-bucket modes:

* **scan** — the fused (possibly int8) filtered top-k kernel over the whole
  device-resident bucket block: cost linear in ``active_rows * cap`` padded
  rows, fully regular, exact (quantized buckets rerank).
* **graph** — the stitched beam traversal (``kernels/graph_topk``, kernel
  B4 per hop) over the
  bucket's adjacency block: cost roughly ``hops * width * degree`` gathers,
  i.e. near-logarithmic in bucket points, but approximate and wasteful
  when the filter is so selective that routing mostly burns hops on
  φ-failing points.
* **host_scan** — the tiered-storage cold path (``streaming/tiering.py``):
  the bucket's block lives in page-locked host memory (evicted under
  ``StreamConfig.device_budget_bytes``) and is copied to the card for each
  dispatch of the same fused kernel — exact, but every dispatch pays the
  transfer.  The planner prices it against "admit the block first, then
  scan / traverse it resident" (``admit_cost_per_byte``), so a repeatedly
  hit cold bucket is admitted instead of streamed again.  The views feed
  it ``resident`` and ``stage_bytes``; the decision logic is the
  reference's, so both packages plan alike.

This module picks the mode *per bucket per dispatch* from the rolling
:class:`~repro_torch.obs.metrics.BucketStats` snapshot plus the bucket's
geometry.  It is host numpy, a copy of the JAX package's planner: the
:class:`PlannerCosts` constants are carried over unchanged, so both
packages make the same decisions from the same snapshot (refitting them to
the card is a later item).

Contract with ``obs/metrics.py``: a per-bucket stats snapshot exposes at
least :data:`REQUIRED_STATS_KEYS`.

The planner only *prices* the modes; it never changes answers on its own:
whenever it picks scan, the dispatch is byte-for-byte the forced-scan one
(the parity property of ``tests/test_torch_graph.py``), and graph picks are
gated on the bucket actually carrying a graph block with live seeds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

__all__ = ["PlannerCosts", "PlanDecision", "READ_PATHS",
           "REQUIRED_STATS_KEYS", "decide_bucket", "plan_read_paths"]

READ_PATHS = ("auto", "scan", "graph")

# Snapshot keys the planner consumes — the BucketStats schema contract.
REQUIRED_STATS_KEYS = ("rows", "rows_scanned", "blocks_pruned",
                       "candidates", "candidate_slots", "dispatches",
                       "queries", "cache_hits", "cache_misses",
                       "pruning_rate", "selectivity")


@dataclasses.dataclass(frozen=True)
class PlannerCosts:
    """Planner constants, in one place (placeholder rooflines).

    Units are abstract "row-visit equivalents"; only ratios matter.  The
    defaults (the reference's, unchanged) make graph win once a bucket's
    padded scan rows exceed a few thousand.
    """

    scan_cost_per_row: float = 1.0      # per padded scanned row
    hop_cost: float = 120.0             # per traversal hop (gather+kernel)
    base_hops: float = 12.0             # fixed hops (seed scoring etc.)
    hops_per_log2: float = 10.0         # extra hops per log2(bucket points)
    seed_cost: float = 0.5              # per stitched seed position
    min_selectivity: float = 0.02       # below this, φ starves routing:
                                        # force scan (traversal would burn
                                        # hops on φ-failing candidates)
    min_graph_rows: int = 512           # don't bother traversing tiny
                                        # buckets — scan is one cheap
                                        # dispatch there
    host_scan_multiplier: float = 4.0   # cold (host-streamed) scan penalty
                                        # per padded row vs. the resident
                                        # scan: the block crosses the host
                                        # link on every dispatch
    admit_cost_per_byte: float = 0.05   # one-shot staging cost of admitting
                                        # a cold bucket block, in
                                        # row-equivalents per byte uploaded
    cost_per_ms: float = 250_000.0      # row-equivalents the rig retires
                                        # per millisecond — converts a
                                        # query deadline's remaining ms
                                        # into a cost ceiling for the
                                        # deadline gate (placeholder like
                                        # everything above)


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One bucket's planned mode plus the estimates behind it."""

    cap: int
    mode: str                           # "scan" | "graph" | "host_scan"
                                        # | "skip" (deadline refusal — the
                                        # bucket is not dispatched and the
                                        # query reports degraded=True)
    est_scan: float                     # resident-scan estimate (host_scan
                                        # decisions price est_scan *
                                        # host_scan_multiplier on top)
    est_graph: float
    reason: str


def estimate_scan_cost(cap: int, active_rows: int,
                       costs: PlannerCosts) -> float:
    """Padded-row scan cost: linear in the temporally unpruned rows."""
    return float(active_rows) * float(cap) * costs.scan_cost_per_row


def estimate_graph_cost(cap: int, active_rows: int, n_seeds: int,
                        costs: PlannerCosts,
                        n_points: Optional[float] = None) -> float:
    """Expected traversal cost: seeds plus hops ~ log2(live bucket points).

    ``n_points`` is the *live* point estimate (from the pack's per-row fill
    counts); without one the padded ``active_rows * cap`` upper bound is
    used, which inflates the hop estimate for partially-filled buckets and
    shifts the scan/graph crossover — callers with fill information should
    always pass it."""
    if n_points is None:
        n_points = float(active_rows) * float(cap)
    n_points = max(float(n_points), 2.0)
    hops = costs.base_hops + costs.hops_per_log2 * math.log2(n_points)
    return hops * costs.hop_cost + float(n_seeds) * costs.seed_cost


def _graph_guard(cap: int, active_rows: int, stats: Optional[Dict],
                 costs: PlannerCosts) -> Optional[str]:
    """Reason the auto policy must not traverse this bucket, else None."""
    if active_rows * cap < costs.min_graph_rows:
        return "small_bucket"
    if stats is not None:
        sel = stats["selectivity"]
        if sel is not None and sel < costs.min_selectivity:
            return "selective_filter"
    return None


def decide_bucket(cap: int, active_rows: int, n_seeds: int,
                  graph_ready: bool, stats: Optional[Dict],
                  costs: PlannerCosts, read_path: str = "auto",
                  resident: bool = True, stage_bytes: int = 0,
                  n_points: Optional[float] = None,
                  deadline_cost: Optional[float] = None) -> PlanDecision:
    """Pick scan vs. graph vs. host_scan for one bucket dispatch.

    ``stats`` is this bucket's entry from a ``BucketStats`` snapshot (or
    ``None`` before any observation); only :data:`REQUIRED_STATS_KEYS` are
    consulted.  ``graph_ready`` and ``n_seeds`` gate the graph mode: a
    bucket without a staged adjacency block or without live entry points
    never traverses regardless of cost (answers must never depend on a
    missing structure).  ``resident=False`` marks a bucket whose block the
    tier evicted to host memory: it either streams through the kernel cold
    (``host_scan`` — exact, pays ``host_scan_multiplier`` per dispatch) or,
    when the one-shot staging cost prices lower, is admitted first and
    dispatched resident (mode ``scan``/``graph`` with reason
    ``admit_cheaper`` — the query path performs the admission).
    ``n_points`` is the live-fill estimate forwarded to
    :func:`estimate_graph_cost`.

    ``deadline_cost`` (remaining query-deadline ms converted to cost
    units via ``PlannerCosts.cost_per_ms``) gates the *cold* modes: the
    planner refuses ``host_scan`` / ``admit_cheaper`` whose priced cost
    the remaining deadline cannot cover, picking whichever cold route
    still fits, or mode ``"skip"`` (reason ``"deadline"``) when neither
    does — the query then omits the bucket and reports an explicitly
    degraded result instead of blowing the budget on a host stream.
    Resident buckets are never skipped here; the query path's
    between-dispatch deadline checks bound those.
    """
    est_scan = estimate_scan_cost(cap, active_rows, costs)
    est_graph = estimate_graph_cost(cap, active_rows, n_seeds, costs,
                                    n_points=n_points)
    can_graph = graph_ready and n_seeds > 0

    def _fits(cost: float) -> bool:
        return deadline_cost is None or cost <= deadline_cost

    if not resident:
        est_host = est_scan * costs.host_scan_multiplier
        stage = float(stage_bytes) * costs.admit_cost_per_byte
        if read_path == "graph" and can_graph:
            return PlanDecision(cap, "graph", est_scan, est_graph, "forced")
        if read_path == "scan":
            if not _fits(est_host):
                return PlanDecision(cap, "skip", est_scan, est_graph,
                                    "deadline")
            return PlanDecision(cap, "host_scan", est_scan, est_graph,
                                "forced")
        best, mode = est_scan, "scan"
        if can_graph and _graph_guard(cap, active_rows, stats, costs) \
                is None and est_graph < est_scan:
            best, mode = est_graph, "graph"
        if stage + best < est_host and _fits(stage + best):
            return PlanDecision(cap, mode, est_scan, est_graph,
                                "admit_cheaper")
        if _fits(est_host):
            return PlanDecision(cap, "host_scan", est_scan, est_graph,
                                "cold_scan_cheaper")
        if _fits(stage + best):
            # the stream is too slow for what's left of the deadline but
            # a one-shot admission still fits — admit and run resident
            return PlanDecision(cap, mode, est_scan, est_graph,
                                "admit_cheaper")
        return PlanDecision(cap, "skip", est_scan, est_graph, "deadline")
    if not can_graph:
        return PlanDecision(cap, "scan", est_scan, est_graph, "graph_unready")
    if read_path == "scan":
        return PlanDecision(cap, "scan", est_scan, est_graph, "forced")
    if read_path == "graph":
        return PlanDecision(cap, "graph", est_scan, est_graph, "forced")
    guard = _graph_guard(cap, active_rows, stats, costs)
    if guard is not None:
        return PlanDecision(cap, "scan", est_scan, est_graph, guard)
    if est_graph < est_scan:
        return PlanDecision(cap, "graph", est_scan, est_graph,
                            "graph_cheaper")
    return PlanDecision(cap, "scan", est_scan, est_graph, "scan_cheaper")


def plan_read_paths(view, read_path: str, stats_snapshot: Dict,
                    costs: PlannerCosts, t_lo: float, t_hi: float,
                    graph_allowed: bool = True,
                    deadline_cost: Optional[float] = None
                    ) -> Dict[int, PlanDecision]:
    """Plan every bucket of a
    :class:`~repro_torch.distributed.segment_shards.PackView`.

    ``stats_snapshot`` is ``BucketStats.snapshot()`` (keys are ``str(cap)``);
    ``graph_allowed=False`` (e.g. the filter has no kernel encoding, so the
    traversal kernel cannot evaluate φ) forces scan everywhere.  Buckets
    whose rows are all temporally pruned are skipped — no dispatch happens
    for them in either mode.  ``deadline_cost`` threads the query's
    remaining deadline (in cost units) into every
    :func:`decide_bucket` call — see the deadline gate there.
    """
    from ..distributed.segment_shards import bucket_graph_seeds
    plan: Dict[int, PlanDecision] = {}
    for bv in view.buckets:
        active = bv.active_rows(t_lo, t_hi)
        n_active = int(np.count_nonzero(active))
        if n_active == 0:
            continue
        resident = getattr(bv, "resident", True)
        fill = getattr(bv, "fill", None)
        n_points = None if fill is None else float(fill[active].sum())
        if not graph_allowed:
            est = estimate_scan_cost(bv.cap, n_active, costs)
            if resident:
                mode = "scan"
            elif deadline_cost is not None \
                    and est * costs.host_scan_multiplier > deadline_cost:
                mode = "skip"             # deadline gate, forced-scan cold
            else:
                mode = "host_scan"
            plan[bv.cap] = PlanDecision(
                bv.cap, mode, est, float("inf"),
                "deadline" if mode == "skip" else "filter_not_encodable")
            continue
        seeds = bucket_graph_seeds(bv, t_lo, t_hi)
        plan[bv.cap] = decide_bucket(bv.cap, n_active, len(seeds),
                                     bv.graph_ready,
                                     stats_snapshot.get(str(bv.cap)),
                                     costs, read_path, resident=resident,
                                     stage_bytes=getattr(bv, "stage_bytes",
                                                         0),
                                     n_points=n_points,
                                     deadline_cost=deadline_cost)
    return plan
