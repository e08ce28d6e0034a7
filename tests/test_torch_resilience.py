"""Resilience in the port (``repro_torch.streaming.resilience`` and the
eleven fault points) against the JAX package.

* ``FaultInjector`` draws exactly as the reference: the same schedule,
  seed and rate fire the same ``(point, hit)`` list in both packages.
* The reference's crash tests (``tests/test_resilience.py``) replayed on
  the port: a crash at each admission point and at each durability point
  recovers bit for bit; deadlines degrade explicitly, never silently.
* The chaos property: the reference's four schedules, its random leg
  (seed 101) and the ``admission.upload`` case it does not absorb
  (``seed=105, quantize="int8", n_shards=1, budget=32768``) hold the port
  bit for bit to its own fault-free oracle, and the final answers equal
  the reference's (ids where distances are unique, distances within
  ``dist_tol``).

The reference side runs fault-free (its oracle) on the tapes' shapes only;
each test that compiles it clears jax's caches after itself.
"""
import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

import repro.streaming as js
from repro.core import CubeGraphConfig as JConfig
from repro.streaming.resilience import FaultInjector as JInjector
import repro_torch.streaming as ts
from repro_torch.core import CubeGraphConfig, IntervalFilter
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.streaming import (FaultError, FaultInjector, QueryResult,
                                   SegmentManager)
from repro_torch.streaming.chaos import (CRASH_POINTS, apply_op,
                                         lifecycle_ops, run_chaos)
from repro_torch.streaming.planner import PlannerCosts
from test_torch_kernels import assert_topk_parity, dist_tol

torch.set_num_threads(1)

IDX = dict(n_layers=2, m_intra=8, m_cross=3)
SCAN_BIASED = dict(hop_cost=1e12)
D, SDIM = 24, 3


@pytest.fixture(autouse=True)
def _jax_clean():
    """Release the reference's compiled executables after each test (its
    tapes compile one executable per bucket shape)."""
    yield
    jax.clear_caches()
    gc.collect()


def _cfg(n_shards=1, budget=None, quantize=None, persist=None, pkg=ts,
         **over):
    idx = (CubeGraphConfig if pkg is ts else JConfig)(**IDX)
    return pkg.StreamConfig(time_dim=2, seal_max_points=1 << 30,
                            n_shards=n_shards, compact_max_segments=3,
                            index_cfg=idx, quantize=quantize,
                            device_budget_bytes=budget, graph_ef=128,
                            persist_dir=persist, wal_fsync_every=4, **over)


def _mgr(cfg):
    return SegmentManager(D, SDIM, cfg, device="cpu")


def _batches(seed, n=3, nb=60):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = r.normal(size=(nb, D)).astype(np.float32)
        s = r.uniform(size=(nb, SDIM))
        s[:, 2] = i * 0.3 + np.linspace(0.0, 0.05, nb)
        out.append((x, s))
    return out


def _sealed_manager(seed=5, n=4, **cfg_over):
    m = _mgr(_cfg(**cfg_over))
    for x, s in _batches(seed, n=n, nb=100):
        m.ingest(x, s)
        m.seal()
    return m


def _q(seed=9, b=4):
    return np.random.default_rng(seed).normal(size=(b, D)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# FaultInjector: the reference's draw, exactly
# ---------------------------------------------------------------------------
def _drive(inj, order):
    fired = []
    for p in order:
        try:
            inj(p)
        except Exception as exc:        # each package's own FaultError
            assert type(exc).__name__ == "FaultError"
            fired.append((p, inj.hits[p]))
    return fired


@pytest.mark.parametrize("seed,rate,max_faults", [
    (7, 0.2, None), (8, 0.18, 5), (101, 0.18, 5), (105, 0.05, None)])
def test_injector_fires_the_reference_list(seed, rate, max_faults):
    """Same schedule, seed, rate and hit order -> the same ``(point,
    hit)`` list in both packages, over all eleven points."""
    from repro.streaming.resilience import FAULT_POINTS as JPOINTS
    assert ts.FAULT_POINTS == JPOINTS
    rng = np.random.default_rng(seed)
    order = [ts.FAULT_POINTS[i] for i in rng.integers(0, 11, size=400)]
    kw = dict(seed=seed, rate=rate, max_faults=max_faults,
              points=CRASH_POINTS,
              schedule={"query.bucket": (3, 9), "wal.append": (2,)})
    got = _drive(FaultInjector(**kw), order)
    want = _drive(JInjector(**kw), order)
    assert got and got == want
    a, b = FaultInjector(**kw), JInjector(**kw)
    _drive(a, order)
    _drive(b, order)
    assert a.hits == b.hits and a.fired == b.fired


def test_injector_caps_delays_disarm():
    """``max_faults`` bounds crashes, ``disarm`` keeps counting without
    firing, ``delays`` stalls instead of raising."""
    inj = FaultInjector(rate=1.0, max_faults=2)
    crashes = 0
    for _ in range(5):
        try:
            inj("pack.delta")
        except FaultError:
            crashes += 1
    assert crashes == 2 and inj.hits["pack.delta"] == 5
    inj.disarm()
    inj("pack.delta")
    assert inj.hits["pack.delta"] == 6 and len(inj.fired) == 2
    inj.arm()
    with pytest.raises(FaultError):
        FaultInjector(schedule={"wal.fsync": (1,)})("wal.fsync")
    stall = FaultInjector(delays={"query.bucket": 0.0})
    stall("query.bucket")
    assert stall.hits["query.bucket"] == 1 and not stall.fired


# ---------------------------------------------------------------------------
# Supervised workers: compaction and prefetch crashes are never lost
# ---------------------------------------------------------------------------
def test_poisoned_compaction_retried_never_lost():
    m = _sealed_manager()
    m.delete(np.arange(0, 250))
    q = _q()
    g0, d0 = m.query(q, None, k=10)
    inj = FaultInjector(schedule={"compaction.execute": (1,)})
    m.install_fault_injector(inj)
    m.compact_async().join(60)
    assert inj.fired == [("compaction.execute", 1)]
    h = m.stats()["health"]["compactor"]
    assert h["errors"] >= 1 and h["retries"] >= 1 and h["runs"] >= 1
    assert not h["degraded"] and "FaultError" in h["last_error"]
    g1, d1 = m.query(q, None, k=10)
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)


def test_poisoned_compaction_trips_degraded_then_recovers():
    m = _sealed_manager(seed=7)
    m.delete(np.arange(0, 250))
    inj = FaultInjector(schedule={"compaction.execute": tuple(range(1, 64))})
    m.install_fault_injector(inj)
    for _ in range(3):
        m.compact_async().join(60)
    h = m.stats()["health"]["compactor"]
    assert h["degraded"] and h["runs"] == 0
    inj.disarm()
    m.compact_async().join(60)
    h2 = m.stats()["health"]["compactor"]
    assert not h2["degraded"] and h2["runs"] >= 1


def test_prefetch_worker_error_recorded():
    m = _sealed_manager(budget=1 << 15)
    inj = FaultInjector(schedule={"prefetch.round": (1,)})
    m.install_fault_injector(inj)
    m.query(_q(), IntervalFilter(dim=2, lo=0.2, hi=0.7), k=10)
    t = m.maybe_prefetch()
    if t is None:
        t = m.supervisor.spawn("prefetcher", m._prefetch_once)
    t.join(60)
    assert inj.hits.get("prefetch.round", 0) >= 1
    h = m.stats()["health"]["prefetcher"]
    assert h["errors"] >= 1 and "FaultError" in h["last_error"]


# ---------------------------------------------------------------------------
# Admission and durability crashes: recover bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("point", ["admission.stage", "admission.upload",
                                   "admission.install"])
def test_admission_crash_is_exact_and_budgeted(point):
    budget = 4 << 20
    m = _sealed_manager(budget=budget)
    q = _q()
    g0, d0 = m.query(q, None, k=10)
    pack = m._pack
    cap = next(iter(pack.buckets))
    assert pack.evict_bucket(cap)
    inj = FaultInjector(schedule={point: (1,)})
    m.install_fault_injector(inj)
    with pytest.raises(FaultError):
        m.tier_admit(cap)
    assert not m._pack.buckets[cap].resident
    assert m.stats()["tier"]["resident_bytes"] <= budget
    inj.disarm()
    g1, d1 = m.query(q, None, k=10)
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    bv = m.tier_admit(cap)
    assert bv is not None and bv.resident
    g2, d2 = m.query(q, None, k=10)
    assert np.array_equal(g0, g2) and np.array_equal(d0, d2)


@pytest.mark.parametrize("point", ["admission.stage", "admission.upload",
                                   "admission.install"])
def test_warm_admission_crash_is_absorbed(point):
    """The divergence from the reference (ROADMAP Queue C): a crash during
    the warm admission a query's pack build makes does not escape the
    query — the bucket stays cold, the answer comes from the cold path
    bit for bit, and the error lands in ``stats()["health"]``."""
    m = _sealed_manager(budget=1 << 22)
    want = _sealed_manager().query(_q(), None, k=10)
    m.install_fault_injector(FaultInjector(schedule={point: (1,)}))
    got = m.query(_q(), None, k=10)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    h = m.stats()["health"]["tier_admission"]
    assert h["errors"] == 1 and "FaultError" in h["last_error"]
    assert not all(b.resident for b in m._pack.buckets.values())


def test_warm_admission_real_error_raises():
    """Only an injected fault is absorbed: any other error during a
    query's warm admission (a device out-of-memory, say) raises out of
    the query, as in the reference, and records no ``tier_admission``."""
    m = _sealed_manager(budget=1 << 22)

    def hook(point):
        if point == "admission.upload":
            raise RuntimeError("out of memory")
    m.install_fault_injector(hook)
    with pytest.raises(RuntimeError, match="out of memory"):
        m.query(_q(), None, k=10)
    assert "tier_admission" not in m.stats()["health"]


def test_planned_admission_crash_is_absorbed():
    """A planner-priced ``admit_cheaper`` admission that crashes inside a
    query leaves the bucket cold; the query answers from the cold view
    bit for bit and records the error (ROADMAP Queue C)."""
    m = _sealed_manager(budget=4 << 20)
    q = _q()
    g0, d0 = m.query(q, None, k=10)
    cap = next(iter(m._pack.buckets))
    assert m._pack.evict_bucket(cap)
    m.cfg = dataclasses.replace(m.cfg, planner_costs=PlannerCosts(
        hop_cost=1e12, admit_cost_per_byte=0.0))
    inj = FaultInjector(schedule={"admission.stage": (1,)})
    m.install_fault_injector(inj)
    g1, d1 = m.query(q, None, k=10, read_path="auto")
    assert inj.fired == [("admission.stage", 1)]
    assert m.last_plan[cap].reason == "admit_cheaper"
    assert not m._pack.buckets[cap].resident
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    assert m.stats()["health"]["tier_admission"]["errors"] == 1


def test_admission_racing_pack_delta_discarded():
    m = _sealed_manager(budget=4 << 20)
    q = _q()
    m.query(q, None, k=10)
    pack = m._pack
    cap = next(iter(pack.buckets))
    assert pack.evict_bucket(cap)
    staged = pack.stage_admission(cap)
    x, s = _batches(77, n=1, nb=60)[0]
    m.ingest(x, s)
    m.seal()
    up = pack.upload_admission(staged)
    assert pack.install_admission(cap, *up) == 0
    assert not pack.buckets[cap].resident
    g0, d0 = m.query(q, None, k=10)
    base = _sealed_manager()
    base.ingest(x, s)
    base.seal()
    gb, db = base.query(q, None, k=10)
    assert np.array_equal(g0, gb) and np.array_equal(d0, db)


@pytest.mark.parametrize("point", ["wal.append", "wal.fsync",
                                   "segment.write", "manifest.rename"])
def test_durability_crash_recovers_exact(point, tmp_path):
    batches = _batches(3, n=3)
    oracle = _mgr(_cfg())
    for x, s in batches:
        oracle.ingest(x, s)
        oracle.seal()
    q = _q()
    og, od = oracle.query(q, None, k=10)
    root = str(tmp_path / point.replace(".", "_"))
    cfg = _cfg(persist=root)
    m = _mgr(cfg)
    inj = FaultInjector(schedule={point: (2,)})
    m.install_fault_injector(inj)
    i = attempts = 0
    while i < len(batches):
        x, s = batches[i]
        pre_n = m.n_total
        try:
            m.ingest(x, s)
            m.seal()
            i += 1
        except FaultError:
            attempts += 1
            if attempts > 6:
                inj.disarm()
            m = SegmentManager.restore(root, cfg=cfg, device="cpu")
            m.install_fault_injector(inj)
            if m.n_total > pre_n:
                m.seal()
                i += 1
    assert inj.fired == [(point, 2)]
    g, d = m.query(q, None, k=10)
    assert np.array_equal(og, g) and np.array_equal(od, d)
    m2 = SegmentManager.restore(root, cfg=cfg, device="cpu")
    g2, d2 = m2.query(q, None, k=10)
    assert np.array_equal(og, g2) and np.array_equal(od, d2)


# ---------------------------------------------------------------------------
# Deadlines: partial results are explicit, never silent
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_deadline_generous_is_bit_for_bit(quantize):
    m = _sealed_manager(quantize=quantize)
    inj = FaultInjector(delays={"query.bucket": 0.0})
    m.install_fault_injector(inj)
    q = _q()
    r0 = m.query(q, None, k=10)
    assert isinstance(r0, QueryResult) and not r0.degraded
    r1 = m.query(q, None, k=10, deadline_ms=60_000.0)
    assert not r1.degraded and r1.reasons == {}
    assert np.array_equal(r0[0], r1[0]) and np.array_equal(r0[1], r1[1])
    # the deadline path dispatched bucket by bucket, firing query.bucket
    assert inj.hits["query.bucket"] == len(m._pack.buckets)


def test_deadline_overrun_marks_degraded():
    m = _sealed_manager()
    q = _q()
    res = m.query(q, None, k=10, deadline_ms=1e-7)
    assert res.degraded and sum(res.reasons.values()) >= 1
    g, d = res
    assert g.shape == (4, 10) and d.shape == (4, 10)
    snap = m.obs.registry.snapshot()["counters"]
    assert snap.get("query_degraded_queries_total", 0) >= 1
    assert any(k.startswith('query_degraded_total{reason="deadline')
               for k in snap)
    m.cfg = dataclasses.replace(m.cfg, query_deadline_ms=1e-7)
    assert m.query(q, None, k=10).degraded
    assert not m.query(q, None, k=10, deadline_ms=60_000.0).degraded


def test_deadline_graph_leg_degrades_explicitly():
    m = _sealed_manager()
    res = m.query(_q(), None, k=10, read_path="graph", deadline_ms=1e-7)
    assert res.degraded
    assert any(r.startswith("deadline") for r in res.reasons)


def test_deadline_result_arities_preserved():
    m = _sealed_manager()
    q = _q()
    r = m.query(q, None, k=10, return_stats=True)
    assert isinstance(r, QueryResult) and len(r) == 3
    rt = m.query(q, None, k=10, return_trace=True, deadline_ms=1e-7)
    assert len(rt) == 3 and rt.degraded


def test_deadline_planner_refuses_cold_scan():
    m = _sealed_manager(budget=0)
    q = _q()
    g0, d0 = m.query(q, None, k=10)
    res = m.query(q, None, k=10, read_path="auto", deadline_ms=1e-7)
    assert res.degraded and "deadline_planner" in res.reasons
    inj = FaultInjector(delays={"query.bucket": 0.0})
    m.install_fault_injector(inj)
    r2 = m.query(q, None, k=10, deadline_ms=60_000.0)
    assert not r2.degraded
    assert np.array_equal(g0, r2[0]) and np.array_equal(d0, r2[1])
    assert inj.hits.get("query.bucket", 0) >= 1


# ---------------------------------------------------------------------------
# The chaos property, and the final answers against the reference
# ---------------------------------------------------------------------------
FINAL_FILTERS = (None, (0.2, 1.2))


def _final(mgr, q, filt, leg):
    f = None if filt is None else IntervalFilter(
        dim=2, lo=np.float32(filt[0]), hi=np.float32(filt[1]))
    if leg == "auto":
        keep = mgr.cfg
        mgr.cfg = dataclasses.replace(
            keep, planner_costs=PlannerCosts(**SCAN_BIASED))
        try:
            return mgr.query(q, f, k=10, read_path="auto")
        finally:
            mgr.cfg = keep
    return mgr.query(q, f, k=10, read_path="scan")


def chaos_ops(seed: int) -> list:
    """The reference test's chaos tape, byte for byte: eight ops drawn from
    ``seed`` (ingest batches of 40-89 points at width 24 with 3 metadata
    columns, op ``j``'s times ``j * 0.3 + [0, 0.05]``; deletes of 15 gids;
    seals; compactions; unfiltered queries of 3 rows), then a seal.  Every
    payload is drawn up front, so an oracle and every recovery attempt
    replay byte-identical operations."""
    rng = np.random.default_rng(seed)
    ops, n = [], 0
    for j in range(8):
        r = int(rng.integers(0, 5)) if n else 0
        if r == 0:
            b = int(rng.integers(40, 90))
            x = rng.normal(size=(b, 24)).astype(np.float32)
            s = rng.uniform(size=(b, 3))
            s[:, 2] = j * 0.3 + np.linspace(0.0, 0.05, b)
            ops.append(("ingest", x, s))
            n += b
        elif r == 1:
            ops.append(("delete", rng.integers(0, n, size=15)))
        elif r == 2:
            ops.append(("seal",))
        elif r == 3:
            ops.append(("compact",))
        else:
            ops.append(("query", rng.normal(size=(3, 24))
                        .astype(np.float32), None))
    ops.append(("seal",))
    return ops


def check_chaos(seed, quantize, n_shards, budget, root):
    """The reference's ``check_chaos`` on the port; returns the final
    manager's answers and the run's record."""
    ops = chaos_ops(seed)
    oracle = _mgr(_cfg(n_shards, budget, quantize))
    want = [apply_op(oracle, op) for op in ops]
    cfg = _cfg(n_shards, budget, quantize, persist=root)
    inj = FaultInjector(seed=seed, rate=0.18, max_faults=5,
                        points=CRASH_POINTS)

    def restore():
        m = SegmentManager.restore(root, cfg=cfg, device="cpu")
        m.install_fault_injector(inj)
        return m

    m = _mgr(cfg)
    m.install_fault_injector(inj)
    rec = run_chaos(m, ops, want, inj, restore)
    m = rec["mgr"]
    q = np.random.default_rng(seed + 1).normal(size=(3, D)) \
        .astype(np.float32)
    finals = {}
    for name, mgr in (("live", m), ("restored", SegmentManager.restore(
            root, cfg=cfg, device="cpu"))):
        for filt in FINAL_FILTERS:
            for leg in ("scan", "auto"):
                og, od = _final(oracle, q, filt, leg)
                gg, dd = _final(mgr, q, filt, leg)
                assert np.array_equal(og, gg), (seed, name, leg, filt)
                assert np.array_equal(od, dd), (seed, name, leg, filt)
                finals[(filt, leg)] = (gg, dd)
            if budget is not None:
                assert mgr.stats()["tier"]["resident_bytes"] <= budget
    return ops, q, finals, inj, m


def _reference_finals(ops, q, n_shards, budget, quantize):
    """The reference's fault-free oracle on the same tape, scan leg."""
    ref = js.SegmentManager(D, SDIM, _cfg(n_shards, budget, quantize,
                                          pkg=js))
    for op in ops:
        if op[0] != "query":
            apply_op(ref, op)
    from repro.core import IntervalFilter as JInterval
    out = {}
    for filt in FINAL_FILTERS:
        f = None if filt is None else JInterval(
            dim=2, lo=np.float32(filt[0]), hi=np.float32(filt[1]))
        out[filt] = ref.query(q, f, k=10, read_path="scan")
    return out


def _tape_points(ops):
    return np.concatenate([op[1] for op in ops if op[0] == "ingest"])


CHAOS_LEGS = [
    (11, None, 1, None),                  # fp32, unbudgeted
    (13, None, 3, 1 << 15),               # fp32, sharded, partial budget
    (17, "int8", 1, 0),                   # quantized, all-cold
    (29, "int8", 3, None),                # quantized, sharded
]


@pytest.mark.parametrize("seed,quantize,n_shards,budget", CHAOS_LEGS)
def test_chaos_schedules(seed, quantize, n_shards, budget, tmp_path):
    """The reference's four schedules: the port recovers to its own
    fault-free oracle bit for bit, live and restored, on both filters
    and both read paths."""
    _, _, _, inj, _ = check_chaos(seed, quantize, n_shards, budget,
                                  str(tmp_path / "chaos"))
    assert inj.fired, "the schedule injected no fault"


@pytest.mark.parametrize("seed,quantize,n_shards,budget",
                         [CHAOS_LEGS[0], CHAOS_LEGS[3]])
def test_chaos_final_answers_match_reference(seed, quantize, n_shards,
                                             budget, tmp_path):
    """After recovery the port's final answers equal the reference's
    fault-free oracle on the same tape (ids where distances are unique,
    distances within ``dist_tol``), fp32 and int8."""
    ops, q, finals, _, _ = check_chaos(seed, quantize, n_shards, budget,
                                       str(tmp_path / "chaos"))
    ref = _reference_finals(ops, q, n_shards, budget, quantize)
    tol = dist_tol(q, _tape_points(ops))
    for filt in FINAL_FILTERS:
        gg, dd = finals[(filt, "scan")]
        jg, jd = ref[filt]
        assert_topk_parity(gg, dd, np.asarray(jg), np.asarray(jd), tol)


def test_chaos_random_seed(tmp_path):
    """The reference's randomized leg at its default seed."""
    check_chaos(101, None, 1, 1 << 15, str(tmp_path / "chaos"))


def test_chaos_absorbs_the_queue_c_admission_upload(tmp_path):
    """``seed=105, quantize="int8", n_shards=1, budget=32768``: in the
    reference an injected ``admission.upload`` fault escapes a query's
    warm admission; the port absorbs it (the bucket stays cold, the
    answer is exact, the error is in ``stats()["health"]``)."""
    _, _, _, inj, m = check_chaos(105, "int8", 1, 32768,
                                  str(tmp_path / "chaos"))
    assert any(p == "admission.upload" for p, _ in inj.fired), inj.fired
    assert "tier_admission" in m.stats()["health"]


def test_chaos_tape_is_the_reference_tape():
    """This file's tape generator draws the reference test's bytes, so the
    chaos tests replay the reference's tapes."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "ref_resilience", os.path.join(os.path.dirname(__file__),
                                       "test_resilience.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for seed in (11, 105):
        a, b = chaos_ops(seed), ref._chaos_ops(seed)
        assert [op[0] for op in a] == [op[0] for op in b]
        for x, y in zip(a, b):
            for u, v in zip(x[1:], y[1:]):
                assert np.array_equal(u, v)


def _lifecycle(quantize, seed=0):
    ops = lifecycle_ops(seed, 2000, D)
    oracle = _mgr(_cfg(2, quantize=quantize))
    want = [apply_op(oracle, op) for op in ops]
    return ops, want, oracle._pack.nbytes // 3


def test_every_fault_point_is_hit(tmp_path):
    """The lifecycle tape (the one ``chip_smoke.py`` phase 5d runs) on a
    persistent manager under a third of its pack's bytes hits each of the
    eleven fault points (counted, with the injector disarmed)."""
    ops, want, budget = _lifecycle(None)
    m = _mgr(_cfg(2, budget, persist=str(tmp_path / "p")))
    inj = FaultInjector()
    inj.disarm()
    m.install_fault_injector(inj)
    rec = run_chaos(m, ops, want, inj, None, deadline_ms=60_000.0)
    assert rec["faults"] == 0 and rec["queries"] > 0
    missing = [p for p in ts.FAULT_POINTS if not inj.hits.get(p)]
    assert not missing, (missing, inj.hits)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_lifecycle_chaos_recovers(quantize, tmp_path):
    """Phase 5d's run at a small size: seeded crashes over the ten crash
    points, every injected crash recovered, every answer the fault-free
    oracle's bit for bit (deadline queries included)."""
    ops, want, budget = _lifecycle(quantize, seed=1)
    root = str(tmp_path / "p")
    cfg = _cfg(2, budget, quantize, persist=root)
    inj = FaultInjector(seed=7, rate=0.18, max_faults=5,
                        points=CRASH_POINTS)

    def restore():
        m = SegmentManager.restore(root, cfg=cfg, device="cpu")
        m.install_fault_injector(inj)
        return m

    m = _mgr(cfg)
    m.install_fault_injector(inj)
    rec = run_chaos(m, ops, want, inj, restore, deadline_ms=60_000.0)
    # crashes on the prefetcher's thread are retried there, not seen here
    assert 1 <= rec["faults"] <= len(inj.fired) <= 5
    assert rec["restores"] == len(rec["recovery_s"]) <= rec["faults"]


def test_metrics_registry_renders_health():
    from repro_torch.obs.metrics import prometheus_text
    from repro_torch.streaming import Supervisor
    reg = MetricsRegistry()
    sup = Supervisor(registry=reg, max_retries=0, sleep=lambda s: None)
    sup.run("compactor", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    text = prometheus_text(reg.snapshot())
    assert 'worker_errors_total{worker="compactor"} 1' in text
    assert 'worker_degraded{worker="compactor"}' in text
