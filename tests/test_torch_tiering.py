"""Tiered bucket storage in the port (``repro_torch.streaming.tiering`` and
the pack's residency state machine) against the JAX package.

* ``TierState`` is host numpy: on the same windows and bucket rows its
  decisions (predicted window, heat, victims, prefetch targets) equal the
  reference's exactly, and so do the planner's cold-bucket decisions.
* Inside the port, any budget answers bit for bit like all-resident:
  cold buckets live in host memory and go through the same kernels (the
  CPU twins here) at the same shapes, on every read path.
* Across packages, budgeted answers match the reference's (ids where
  distances are unique, distances within ``dist_tol``).  Which buckets are
  resident at a given budget is never compared: the port's pack has no
  lane padding, so it holds fewer bytes for the same buckets.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.streaming as js
from repro.core import IntervalFilter as JInterval
from repro.core.workloads import make_box_filter as jax_box
from repro.streaming import planner as jplanner
from repro.streaming.tiering import TierState as JTier
import repro_torch.streaming as ts
from repro_torch.core import CubeGraphConfig, IntervalFilter
from repro_torch.core.workloads import make_box_filter
from repro_torch.distributed import segment_shards as tss
from repro_torch.distributed.segment_shards import host_topk
from repro_torch.streaming import planner as tplanner
from repro_torch.streaming.tiering import TierState, host_reference_topk
from test_torch_kernels import assert_topk_parity, dist_tol

torch.set_num_threads(1)

IDX = dict(n_layers=2, m_intra=8, m_cross=3)
# graph priced out: auto picks a scan-family mode everywhere (scan,
# host_scan, admit-then-scan), all exact, while exercising the pricing
SCAN_BIASED = dict(hop_cost=1e12)


def _cfg(pkg, n_shards, budget, quantize=None, **over):
    return pkg.StreamConfig(
        time_dim=2, seal_max_points=120, n_shards=n_shards,
        compact_max_segments=3, ttl=1.5,
        index_cfg=pkg.manager.CubeGraphConfig(**IDX), quantize=quantize,
        device_budget_bytes=budget, graph_ef=128, **over)


def _ops(mgr, rng, ops, d=24):
    """The reference test's op coding: ingest / delete / seal / compact /
    expire."""
    t = getattr(mgr, "_test_t", 0.0)
    for op in ops:
        if op == 0 or mgr.n_total == 0:
            nb = int(rng.integers(40, 150))
            x = rng.normal(size=(nb, d)).astype(np.float32)
            s = rng.uniform(size=(nb, 3))
            s[:, 2] = t + np.linspace(0.0, 0.05, nb)
            t += 0.25
            mgr.ingest(x, s)
        elif op == 1:
            mgr.delete(rng.integers(0, mgr.n_total, size=25))
        elif op == 2:
            mgr.seal()
        elif op == 3:
            mgr.compact()
        elif op == 4:
            mgr.expire()
    mgr._test_t = t


def _port_mgr(cfg):
    return ts.SegmentManager(24, 3, cfg, device="cpu")


# ---------------------------------------------------------------------------
# TierState and the planner: the reference's decisions exactly
# ---------------------------------------------------------------------------
def _meta_rows(rng, n):
    rows = []
    for i in range(n):
        t0 = float(rng.uniform(-5, 10))
        rows.append({"cap": 256 << i, "resident": bool(rng.random() < 0.6),
                     "nbytes": int(rng.integers(1, 5)) * 100,
                     "t_min": t0, "t_max": t0 + float(rng.uniform(0, 3)),
                     "stats": (None if rng.random() < 0.4 else
                               {"dispatches": int(rng.integers(0, 50))})})
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_tier_state_decisions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    jt, tt = JTier(1000, window_history=4), TierState(1000, window_history=4)
    assert tt.predicted_window() is None and tt.prefetch_targets([]) == []
    for step in range(10):
        lo = float(rng.uniform(-2, 8))
        win = [(lo, lo + float(rng.uniform(-0.5, 3))),
               (np.inf, np.inf), (lo, lo + 1.0)][int(rng.integers(0, 3))]
        jt.note_window(*win)
        tt.note_window(*win)
        assert tt.recent_window() == jt.recent_window()
        assert tt.predicted_window() == jt.predicted_window()
        meta = _meta_rows(rng, int(rng.integers(1, 7)))
        assert [tt.heat(m) for m in meta] == [jt.heat(m) for m in meta]
        need = int(rng.integers(0, 1200))
        assert tt.pick_victims(meta, need) == jt.pick_victims(meta, need)
        assert tt.prefetch_targets(meta) == jt.prefetch_targets(meta)


def test_decide_bucket_cold_equals_reference():
    rng = np.random.default_rng(3)
    for _ in range(200):
        cap = int(256 << int(rng.integers(0, 6)))
        args = (cap, int(rng.integers(1, 32)), int(rng.integers(0, 12)),
                bool(rng.random() < 0.7),
                None if rng.random() < 0.5 else {
                    "selectivity": float(rng.uniform(0, 1)),
                    "dispatches": 3, "fill": 0.5, "mean_hops": 10.0,
                    "hops_ema": 10.0})
        over = dict(admit_cost_per_byte=float(rng.choice([0.0, 1e-3, 1e9])),
                    host_scan_multiplier=float(rng.choice([1.0, 4.0, 1e3])))
        kw = dict(read_path=str(rng.choice(["scan", "graph", "auto"])),
                  resident=bool(rng.random() < 0.3),
                  stage_bytes=int(rng.integers(0, 1 << 22)),
                  n_points=None if rng.random() < 0.5
                  else float(rng.integers(1, 5000)),
                  deadline_cost=None if rng.random() < 0.5
                  else float(rng.uniform(0, 1e6)))
        dj = jplanner.decide_bucket(
            *args, dataclasses.replace(jplanner.PlannerCosts(), **over), **kw)
        dt = tplanner.decide_bucket(
            *args, dataclasses.replace(tplanner.PlannerCosts(), **over), **kw)
        assert (dt.mode, dt.reason) == (dj.mode, dj.reason), (args, kw)
        assert dt.est_scan == dj.est_scan and dt.est_graph == dj.est_graph


# ---------------------------------------------------------------------------
# Any budget == all-resident, bit for bit, inside the port
# ---------------------------------------------------------------------------
def _budget_pair(seed, n_shards, ops, quantize, budget):
    base = _port_mgr(_cfg(ts, n_shards, None, quantize))
    tiered = _port_mgr(_cfg(ts, n_shards, budget, quantize))
    for mgr in (base, tiered):
        _ops(mgr, np.random.default_rng(seed), ops)
        mgr.seal()
    return base, tiered


def _filters(seed):
    return [None, make_box_filter(3, 0.6, seed=seed),
            IntervalFilter(dim=2, lo=np.float32(0.2), hi=np.float32(1.2))]


@pytest.mark.parametrize("seed,n_shards,ops,quantize,budget", [
    (7, 1, [0, 1, 2, 0, 3, 1, 4], None, 0),            # all cold, fp32
    (19, 3, [0, 2, 1, 3, 0, 0, 4, 2], None, 1 << 16),  # partial, sharded
    (23, 1, [0, 1, 2, 0, 3], "int8", 0),               # all cold, int8
    (31, 3, [0, 2, 0, 2, 1, 3], "int8", 1 << 15),      # partial, int8
])
def test_any_budget_equals_all_resident(seed, n_shards, ops, quantize,
                                        budget):
    """Two port managers differing only in device_budget_bytes answer
    every filter and read path (forced scan, forced graph over the cold
    adjacency, auto with graph priced out) bit for bit, and the resident
    bytes stay within the budget after every query."""
    base, tiered = _budget_pair(seed, n_shards, ops, quantize, budget)
    assert base.tier is None and tiered.tier.budget_bytes == budget
    q = np.random.default_rng(seed + 1).normal(size=(4, 24)) \
        .astype(np.float32)
    cfg_t, cfg_b = tiered.cfg, base.cfg
    for filt in _filters(seed):
        for leg in ("scan", "graph", "auto"):
            if leg == "auto":
                costs = tplanner.PlannerCosts(**SCAN_BIASED)
                tiered.cfg = dataclasses.replace(cfg_t, planner_costs=costs)
                base.cfg = dataclasses.replace(cfg_b, planner_costs=costs)
            ga, da = base.query(q, filt, k=10, read_path=leg)
            gb, db = tiered.query(q, filt, k=10, read_path=leg)
            tiered.cfg, base.cfg = cfg_t, cfg_b
            assert np.array_equal(ga, gb), (filt, leg)
            assert np.array_equal(da, db), (filt, leg)
            st = tiered.stats()["tier"]
            assert st["resident_bytes"] <= budget, (filt, leg, st)
    counters = tiered.stats()["obs"]["metrics"]["counters"]
    assert counters.get("tier_miss_total", 0) > 0


@pytest.mark.parametrize("quantize,budget", [(None, 1 << 15),
                                             ("int8", 1 << 13)])
def test_budget_answers_match_reference(quantize, budget):
    """The same op stream under the same budget in both packages: equal
    ids where distances are unique, distances within dist_tol (resident
    sets may differ: the layouts differ in bytes)."""
    ops = [0, 2, 1, 0, 2, 3, 0]
    jm = js.SegmentManager(24, 3, _cfg(js, 2, budget, quantize))
    tm = _port_mgr(_cfg(ts, 2, budget, quantize))
    for mgr in (jm, tm):
        _ops(mgr, np.random.default_rng(5), ops)
        mgr.seal()
    q = np.random.default_rng(6).normal(size=(6, 24)).astype(np.float32)
    x = tm.get_points(np.arange(tm.n_total))[0]
    for jf, tf in ((None, None),
                   (JInterval(dim=2, lo=np.float32(0.3), hi=np.float32(1.0)),
                    IntervalFilter(dim=2, lo=np.float32(0.3),
                                   hi=np.float32(1.0))),
                   (jax_box(3, 0.6, seed=4), make_box_filter(3, 0.6, seed=4))):
        gj, dj = jm.query(q, jf, k=10, read_path="scan")
        gt, dt = tm.query(q, tf, k=10, read_path="scan")
        assert_topk_parity(gt, dt, gj, dj, dist_tol(q, x))
        assert tm.stats()["tier"]["resident_bytes"] <= budget


# ---------------------------------------------------------------------------
# Churn under a drifting window, prefetch, restore under a budget
# ---------------------------------------------------------------------------
def _era_managers(budget_frac=2):
    d = 16
    eras = ((3, 300), (2, 600), (1, 1200))
    rng = np.random.default_rng(71)
    n = sum(k * sz for k, sz in eras)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.uniform(size=(n, 3))
    s[:, 2] = np.linspace(0.0, 9.0, n)

    def ingest(mgr):
        lo = 0
        for n_segs, size in eras:
            for _ in range(n_segs):
                mgr.ingest(x[lo:lo + size], s[lo:lo + size])
                mgr.seal()
                lo += size

    def mk(budget):
        return ts.SegmentManager(d, 3, ts.StreamConfig(
            time_dim=2, seal_max_points=1 << 30, n_shards=2,
            device_budget_bytes=budget, index_cfg=CubeGraphConfig(**IDX)),
            device="cpu")

    base = mk(None)
    ingest(base)
    q = x[rng.integers(0, n, 4)].copy()
    base.query(q, None, k=10)
    budget = max(base.stats()["pack_nbytes"] // budget_frac, 1)
    tiered = mk(budget)
    ingest(tiered)
    return base, tiered, budget, q


def test_tier_churn_budget_invariant_and_counters():
    base, tiered, budget, q = _era_managers()
    for lo in np.linspace(0.0, 6.0, 7):
        f = IntervalFilter(dim=2, lo=np.float32(lo), hi=np.float32(lo + 3))
        g_b, d_b = base.query(q, f, k=10, read_path="scan")
        g_t, d_t = tiered.query(q, f, k=10, read_path="scan")
        if tiered._prefetch_thread is not None:
            tiered._prefetch_thread.join(timeout=60)
        tiered._prefetch_once()                 # a deterministic round
        assert np.array_equal(g_b, g_t) and np.array_equal(d_b, d_t)
        st = tiered.stats()["tier"]
        assert st["resident_bytes"] <= budget
        assert st["resident_bytes"] + st["host_bytes"] > 0
    assert tiered._prefetch_once() == 0
    c = tiered.stats()["obs"]["metrics"]["counters"]
    assert c.get("tier_evictions_total", 0) > 0
    assert c.get("tier_prefetch_admissions_total", 0) > 0
    assert c.get("tier_miss_total", 0) > 0
    g = tiered.stats()["obs"]["metrics"]["gauges"]
    assert g["tier_budget_bytes"] == budget
    assert g["tier_resident_bytes"] <= budget
    # prefetch off: maybe_prefetch is a no-op
    tiered.cfg = dataclasses.replace(tiered.cfg, tier_prefetch=False)
    assert tiered.maybe_prefetch() is None


def test_restore_under_budget_equals_original(tmp_path):
    """A budgeted replica of an unbudgeted writer's snapshot answers its
    first query from a partly resident pack with the writer's answers."""
    base, _, budget, q = _era_managers()
    snap = os.path.join(str(tmp_path), "snap")
    base.snapshot_to(snap)
    f = IntervalFilter(dim=2, lo=np.float32(6.0), hi=np.float32(9.0))
    g0, d0 = base.query(q, f, k=10, read_path="scan")
    cfg = dataclasses.replace(base.cfg, device_budget_bytes=budget)
    m2 = ts.SegmentManager.restore(snap, cfg=cfg, device="cpu",
                                   resume=False)
    g1, d1 = m2.query(q, f, k=10, read_path="scan")
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    st = m2.stats()["tier"]
    assert 0 < st["resident_bytes"] <= budget and st["host_bytes"] > 0


def test_query_path_admits_when_planner_prices_admission():
    rng = np.random.default_rng(47)
    mgr = ts.SegmentManager(16, 3, ts.StreamConfig(
        time_dim=2, seal_max_points=1 << 30, n_shards=1,
        device_budget_bytes=1 << 30, index_cfg=CubeGraphConfig(**IDX)),
        device="cpu")
    mgr.ingest(rng.normal(size=(300, 16)).astype(np.float32),
               rng.uniform(size=(300, 3)))
    mgr.seal()
    q = rng.normal(size=(3, 16)).astype(np.float32)
    g0, d0 = mgr.query(q, None, k=5)
    with mgr._lock:
        cap = next(iter(mgr._pack.buckets))
        assert mgr._pack.evict_bucket(cap) > 0
    base = mgr.cfg
    mgr.cfg = dataclasses.replace(base, planner_costs=tplanner.PlannerCosts(
        hop_cost=1e12, admit_cost_per_byte=1e9))
    g1, d1 = mgr.query(q, None, k=5, read_path="auto")
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    assert [p.reason for p in mgr.last_plan.values()] == \
        ["cold_scan_cheaper"]
    assert not mgr._pack.buckets[cap].resident
    mgr.cfg = dataclasses.replace(base, planner_costs=tplanner.PlannerCosts(
        hop_cost=1e12, admit_cost_per_byte=0.0, host_scan_multiplier=1e9))
    g2, d2 = mgr.query(q, None, k=5, read_path="auto")
    assert np.array_equal(g0, g2) and np.array_equal(d0, d2)
    assert [p.reason for p in mgr.last_plan.values()] == ["admit_cheaper"]
    assert mgr._pack.buckets[cap].resident
    c = mgr.stats()["obs"]["metrics"]["counters"]
    assert c.get("tier_admissions_total", 0) >= 1
    assert c.get("tier_miss_total", 0) >= 1


# ---------------------------------------------------------------------------
# The pack's residency state machine
# ---------------------------------------------------------------------------
def _pack(rng, graph=False):
    from repro_torch.distributed.segment_shards import (SegmentShardSource,
                                                        build_bucketed_pack)
    srcs = []
    for sid, n in enumerate((100, 150, 700)):
        x = rng.normal(size=(n, 12)).astype(np.float32)
        s = rng.uniform(size=(n, 3)).astype(np.float64)
        nb = rng.integers(-1, n, size=(n, 6)).astype(np.int32) \
            if graph else None
        srcs.append(SegmentShardSource(
            sid, x, s, np.arange(sid * 1000, sid * 1000 + n), 0.0, 1.0,
            nbrs=nb, entries=np.arange(3, dtype=np.int32) if graph else None))
    return build_bucketed_pack(srcs, n_shards=2, device="cpu",
                               graph_degree=6 if graph else None)


def test_residency_state_machine():
    rng = np.random.default_rng(8)
    pack = _pack(rng, graph=True)
    cap = max(pack.buckets)
    b = pack.buckets[cap]
    before = pack.view()
    full, nb0 = b.full_nbytes, pack.nbytes
    assert b.nbytes == full and pack.host_nbytes == 0
    assert pack.evict_bucket(cap) == full and pack.evict_bucket(cap) == 0
    assert pack.nbytes == nb0 - full and pack.host_nbytes == full
    cold = pack.view()
    cv = next(v for v in cold.buckets if v.cap == cap)
    rv = next(v for v in before.buckets if v.cap == cap)
    assert not cv.resident and cv.stage_bytes == full
    for name in ("x", "s", "gids", "nbrs"):
        assert torch.equal(cv.block(name), rv.block(name))
    assert pack.bucket_stats()[cap]["resident"] == 0
    # a cold mutation is copy-on-write: the captured cold view keeps its
    # bytes, the next view sees the sentinel
    dead = int(cv.block("gids")[0, 0])
    assert pack.mark_dead([dead]) == 1
    assert float(cv.block("s")[0, 0, 0]) < 1e29
    assert float(pack.bucket_view(cap).block("s")[0, 0, 0]) > 1e29
    # a stale admission (a delta landed mid-upload) is discarded
    staged = pack.stage_admission(cap)
    up = pack.upload_admission(staged)
    pack.mark_dead([dead + 1])
    assert pack.install_admission(cap, *up) == 0
    assert not pack.buckets[cap].resident
    # fault hooks fire in order and a crash leaves the bucket cold
    seen = []

    def hook(point):
        seen.append(point)
        if point == "admission.upload":
            raise RuntimeError(point)
    pack.fault_hook = hook
    with pytest.raises(RuntimeError):
        pack.admit_bucket(cap)
    assert seen == ["admission.stage", "admission.upload"]
    assert not pack.buckets[cap].resident
    pack.fault_hook = None
    assert pack.admit_bucket(cap) == full and pack.buckets[cap].resident
    assert pack.nbytes == nb0
    # a cold build holds every bucket in host memory
    cold_pack = tss.build_bucketed_pack(
        [tss.SegmentShardSource(0, np.ones((5, 12), np.float32),
                                np.zeros((5, 3)), np.arange(5), 0.0, 1.0)],
        n_shards=2, device="cpu", resident_default=False)
    assert cold_pack.nbytes == 0 and cold_pack.host_nbytes > 0


def test_cold_dispatch_equals_resident_and_host_reference():
    """A cold bucket's B1 dispatch (the twin here) equals the resident
    block's bit for bit; host_reference_topk agrees with it (ids, and
    distances within dist_tol)."""
    rng = np.random.default_rng(9)
    pack = _pack(rng)
    q = rng.normal(size=(5, 12)).astype(np.float32)
    filt = make_box_filter(3, 0.5, seed=2)
    resident = tss.pack_search_blocks(pack.view(), q, filt, 10)
    misses = []
    for cap in list(pack.buckets):
        pack.evict_bucket(cap)
    cold_view = pack.view()
    cold = tss.pack_search_blocks(cold_view, q, filt, 10,
                                  on_cold=lambda c, n: misses.append(c))
    assert misses == [bv.cap for bv in cold_view.buckets]
    for (ga, da), (gb, db) in zip(resident, cold):
        assert np.array_equal(ga, gb) and np.array_equal(da, db)
    x = np.concatenate([bv.block("x").reshape(-1, 12).numpy()
                        for bv in cold_view.buckets])
    for bv, (gk, dk) in zip(cold_view.buckets, cold):
        gh, dh = host_reference_topk(bv, q, filt, gk.shape[1], -np.inf,
                                     np.inf, m=3)
        assert_topk_parity(gh, dh, gk, dk, dist_tol(q, x))
    og, od = host_topk(np.concatenate([g for g, _ in cold], 1),
                       np.concatenate([d for _, d in cold], 1), 10)
    assert (og >= 0).any()


def test_document_store_budget():
    import repro_torch.serving.rag as trag
    rng = np.random.default_rng(12)
    n = 400
    x = rng.normal(size=(n, 16)).astype(np.float32)
    s = rng.uniform(size=(n, 3))
    s[:, 2] = np.arange(n) / n
    docs = [trag.Document(doc_id=i, tokens=np.arange(4, dtype=np.int32),
                          embedding=x[i], metadata=s[i]) for i in range(n)]
    cfg = ts.StreamConfig(time_dim=2, seal_max_points=100,
                          index_cfg=CubeGraphConfig(**IDX))
    full = trag.DocumentStore(docs, streaming=True, stream_cfg=cfg,
                              read_path="scan", device="cpu")
    tier = trag.DocumentStore(docs, streaming=True, stream_cfg=cfg,
                              device_budget_bytes=0, device="cpu")
    assert tier.manager.cfg.n_shards >= 1
    assert tier.manager.cfg.device_budget_bytes == 0
    f = IntervalFilter(dim=2, lo=np.float32(0.2))
    a = full.retrieve(x[:4], f, k=5)
    b = tier.retrieve(x[:4], f, k=5)
    assert [[d.doc_id for d in r] for r in a] == \
        [[d.doc_id for d in r] for r in b]
    with pytest.raises(ValueError):
        trag.DocumentStore(docs[:20], device_budget_bytes=0, device="cpu")
