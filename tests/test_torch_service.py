"""The multi-tenant serving tier in the port (``repro_torch.serving``
batching / tenancy / service / workload and the grouped read path under
them) against the JAX package.

* Grouped == solo, bit for bit, inside the port at every layer:
  ``sharded_filtered_topk_grouped``, ``pack_search_blocks_grouped``,
  ``SegmentManager.query_grouped``, ``DocumentStore.retrieve_grouped`` and
  a service flush against solo ``MultiTenantStore.retrieve``.
* The port's grouped answers equal the reference's (ids where distances
  are unique, distances within ``dist_tol``).
* ``_filter_key`` keys equal exactly where the reference's does.
* Quotas, ownership, isolation under a racing writer (threads drive the
  port only), the snapshot round trip, the async loop, and the workload
  smoke's report keys (the reference's ``SLO_REPORT_KEYS``).
* On the CPU every kernel call takes its plain twin: no launch counts.

The reference side runs one small manager; its compiled executables are
released after each test.
"""
import gc
import importlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.streaming as js
from repro.core import BoxFilter as JBox
from repro.core import ComposeFilter as JCompose
from repro.core import CubeGraphConfig as JConfig
from repro.core import IntervalFilter as JInterval
from repro.serving.batching import _filter_key as j_filter_key
from repro_torch.core import (BallFilter, BoxFilter, ComposeFilter,
                              CubeGraphConfig, IntervalFilter, PolygonFilter)
from repro_torch.distributed import segment_shards as tss
from repro_torch.kernels.ops import (sharded_filtered_topk,
                                     sharded_filtered_topk_grouped)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.batching import (RetrievalBatcher, RetrievalFailure,
                                          RetrievalRequest, _filter_key)
from repro_torch.serving.rag import Document, DocumentStore
from repro_torch.serving.service import (AdmissionController,
                                         CubeGraphService, ServeRequest)
from repro_torch.serving.tenancy import (MultiTenantStore,
                                         TenantIsolationError,
                                         TenantQuotaError)
import repro_torch.streaming as ts
from test_torch_kernels import assert_topk_parity, dist_tol, port_filter

torch.set_num_threads(1)

IDX = dict(n_layers=2, m_intra=8, m_cross=4)
D, M = 8, 3
b1 = importlib.import_module("repro_torch.kernels.filtered_topk")


@pytest.fixture(autouse=True)
def _jax_clean():
    """Release the reference's compiled executables after each test."""
    yield
    jax.clear_caches()
    gc.collect()


def _stream_cfg(pkg=ts, **kw):
    kw.setdefault("time_dim", 2)
    kw.setdefault("seal_max_points", 64)
    kw.setdefault("n_shards", 2)
    kw.setdefault("index_cfg", (CubeGraphConfig if pkg is ts
                                else JConfig)(**IDX))
    return pkg.StreamConfig(**kw)


def _docs(rng, n, base=0):
    return [Document(doc_id=base + i,
                     tokens=np.arange(3, dtype=np.int32),
                     embedding=rng.standard_normal(D).astype(np.float32),
                     metadata=np.array([rng.uniform(0, 10),
                                        rng.uniform(0, 10), float(i)]))
            for i in range(n)]


def _two_tenant_store(rng, n=150, **cfg_kw):
    store = MultiTenantStore(D, M, stream_cfg=_stream_cfg(**cfg_kw),
                             device="cpu")
    for tenant, base in (("a", 0), ("b", 10_000)):
        store.create_collection(tenant)
        store.insert(tenant, _docs(rng, n, base=base))
    store.maintenance()
    return store


def _filters():
    return (BoxFilter(lo=np.float32([0, 0, -1e9]),
                      hi=np.float32([8, 8, 1e9])),
            ComposeFilter(BoxFilter(lo=np.float32([0, 0, -1e9]),
                                    hi=np.float32([9, 9, 1e9])),
                          IntervalFilter(dim=2, lo=10.0, hi=120.0), "and"),
            None)


# ---------------------------------------------------------------------------
# Grouped == solo inside the port, layer by layer
# ---------------------------------------------------------------------------
def _stack(rng, g=3, n=300):
    xs = torch.as_tensor(rng.normal(size=(g, n, D)).astype(np.float32))
    ss = torch.as_tensor(rng.uniform(0, 10, size=(g, n, M))
                         .astype(np.float32))
    return xs, ss


def test_sharded_grouped_equals_solo_bit_for_bit():
    """Two encodable classes (box kpad 16, ball kpad 32) of uneven row
    counts, a singleton class, a filter without an encoding (polygon)
    and an unfiltered group: every group's grouped answer is its solo
    call's, and no launch is counted on the CPU."""
    rng = np.random.default_rng(0)
    xs, ss = _stack(rng)
    box = lambda lo: BoxFilter(lo=np.float32([lo, 0, 0]),    # noqa: E731
                               hi=np.float32([9, 9, 10]))
    ball = BallFilter(center=np.float32([5, 5]), radius=np.float32(3.0))
    poly = PolygonFilter(vertices=np.float32([[0, 0], [9, 1], [5, 9]]),
                         rest_lo=np.float32([-1e9]),
                         rest_hi=np.float32([1e9]))
    groups = [(rng.normal(size=(b, D)).astype(np.float32), f, k)
              for b, f, k in ((3, box(0), 10), (7, box(2), 9),
                              (1, box(4), 16), (5, ball, 20),
                              (2, ball, 17), (4, poly, 5), (6, None, 40),
                              (2, IntervalFilter(dim=2, lo=2.0), 10))]
    before = b1.launch_count()
    got = sharded_filtered_topk_grouped(groups, xs, ss, m=M)
    assert b1.launch_count() == before
    assert len(got) == len(groups)
    for (q, f, k), (gi, gd) in zip(groups, got):
        si, sd = sharded_filtered_topk(q, xs, ss, f, k, m=M)
        assert gi.shape == (xs.shape[0], q.shape[0], k)
        assert torch.equal(gi, si) and torch.equal(gd, sd)


def test_grouped_twin_equals_stacked_solo_twins():
    """The grouped launch's twin over ``[G, bq, d]`` queries and ``[G, g,
    bq, d]`` queries is the solo twin of each group over the shard stack."""
    rng = np.random.default_rng(1)
    xs, ss = _stack(rng, g=2, n=200)
    from repro_torch.kernels.ops import encode_filter
    params = torch.stack([torch.as_tensor(encode_filter(
        BoxFilter(lo=np.float32([lo, 0, 0]), hi=np.float32([9, 9, 10])),
        M, mpad=M)[1]) for lo in (0, 3, 6)])
    q3 = torch.as_tensor(rng.normal(size=(3, 5, D)).astype(np.float32))
    q4 = torch.as_tensor(rng.normal(size=(3, 2, 5, D)).astype(np.float32))
    for q in (q3, q4):
        dd, ii = b1.filtered_topk_grouped_call(q, xs, ss, params, "box", 16)
        assert dd.shape == (3, 2, 5, 16)
        for gi in range(3):
            qg = q[gi] if q.dim() == 4 else q[gi][None]
            sd, si = b1.filtered_topk_call(qg, xs, ss, params[gi][None],
                                           "box", 16)
            assert torch.equal(dd[gi], sd) and torch.equal(ii[gi], si)


def _manager(pkg, rng_seed=0, n=400, **kw):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    s = rng.uniform(0, 10, size=(n, M))
    s[:, 2] = np.arange(n)
    cfg = _stream_cfg(pkg, **kw)
    m = (ts.SegmentManager(D, M, cfg, device="cpu") if pkg is ts
         else js.SegmentManager(D, M, cfg))
    m.ingest(x[: n - 30], s[: n - 30])
    m.maintenance()
    m.ingest(x[n - 30:], s[n - 30:])          # a live delta too
    m.delete(np.arange(0, n, 7))
    return m, x


def _group_specs(rng):
    """Four groups of one kernel class (box, kpad 16) and mixed k, of
    uneven row counts: the reference compiles one grouped dispatch per
    bucket shape."""
    fs = [JBox(lo=np.float32([0, 0, -1e9]), hi=np.float32([8, 8, 1e9])),
          JInterval(dim=2, lo=np.float32(10.0), hi=np.float32(250.0)),
          JBox(lo=np.float32([1, 1, -1e9]), hi=np.float32([9, 9, 300.0])),
          JCompose(JBox(lo=np.float32([2, 0, -1e9]),
                        hi=np.float32([9, 7, 1e9])),
                   JInterval(dim=2, lo=np.float32(100.0)), "and")]
    return [(rng.normal(size=(2 + 3 * i, D)).astype(np.float32), f,
             (5, 10)[i % 2]) for i, f in enumerate(fs)]


def test_query_grouped_equals_solo_and_reference():
    """``query_grouped`` over a pack with a live delta and deletes: each
    group bit for bit its solo ``query`` in the port, and equal to the
    reference's ``query_grouped`` answers."""
    specs = _group_specs(np.random.default_rng(3))
    tm, x = _manager(ts)
    got = tm.query_grouped([ts.GroupQuery(q, port_filter(f), k=k)
                            for q, f, k in specs])
    for (q, f, k), r in zip(specs, got):
        solo = tm.query(q, port_filter(f), k=k)
        assert np.array_equal(r[0], solo[0])
        assert np.array_equal(r[1], solo[1])
        assert not r.degraded
    jm, _ = _manager(js)
    want = jm.query_grouped([js.GroupQuery(q, f, k=k) for q, f, k in specs])
    for (q, _, _), r, w in zip(specs, got, want):
        assert_topk_parity(r[0], r[1], np.asarray(w[0]), np.asarray(w[1]),
                           dist_tol(q, x))


def test_query_grouped_falls_back_and_degrades_per_group():
    """int8 / graph groups fall back to solo queries with equal answers;
    an expired deadline degrades only its own group."""
    rng = np.random.default_rng(4)
    specs = _group_specs(rng)
    tm, _ = _manager(ts, quantize="int8")
    gqs = [ts.GroupQuery(q, port_filter(f), k=k) for q, f, k in specs]
    for r, (q, f, k) in zip(tm.query_grouped(gqs), specs):
        solo = tm.query(q, port_filter(f), k=k)
        assert np.array_equal(r[0], solo[0])
        assert np.array_equal(r[1], solo[1])
    fm, _ = _manager(ts)
    gqs = [ts.GroupQuery(q, port_filter(f), k=k,
                         deadline_ms=0.0 if i == 1 else None)
           for i, (q, f, k) in enumerate(specs)]
    inj = ts.FaultInjector(delays={"query.bucket": 0.0})
    fm.install_fault_injector(inj)
    res = fm.query_grouped(gqs)
    assert res[1].degraded and res[1].reasons["deadline_sealed_scan"] >= 1
    assert not any(r.degraded for i, r in enumerate(res) if i != 1)
    assert inj.hits["query.bucket"] >= 1


def test_pack_search_blocks_grouped_equals_solo():
    """Per-group temporal masks and ``observe_group``: every group's
    blocks are its solo ``pack_search_blocks`` blocks, cold buckets
    included."""
    tm, _ = _manager(ts, device_budget_bytes=0)
    epoch, segs, _ = tm.snapshot()
    view = tm.shard_pack(epoch, [g for g in segs if g.n_live])
    assert not any(bv.resident for bv in view.buckets)
    rng = np.random.default_rng(5)
    groups = [(rng.normal(size=(3, D)).astype(np.float32),
               port_filter(f), k, lo, hi)
              for (_, f, k), (lo, hi) in zip(
                  _group_specs(rng), ((-np.inf, np.inf), (10.0, 250.0),
                                      (-np.inf, 300.0), (100.0, np.inf)))]
    seen, cold = [], []
    per = tss.pack_search_blocks_grouped(
        view, groups, observe_group=lambda gi, cap, **kw: seen.append(gi),
        on_cold=lambda cap, nbytes: cold.append(cap))
    assert len(cold) == len(view.buckets) and set(seen) == {0, 1, 2, 3}
    for (q, f, k, lo, hi), blocks in zip(groups, per):
        solo = tss.pack_search_blocks(view, q, f, k, t_lo=lo, t_hi=hi)
        assert len(blocks) == len(solo)
        for (g1, d1), (g2, d2) in zip(blocks, solo):
            assert np.array_equal(g1, g2) and np.array_equal(d1, d2)


def test_document_store_retrieve_grouped_parity():
    rng = np.random.default_rng(1)
    store = DocumentStore(_docs(rng, 200), index_cfg=CubeGraphConfig(**IDX),
                          streaming=True, stream_cfg=_stream_cfg(),
                          device="cpu")
    store.maintenance()
    filters = (BoxFilter(lo=np.float32([0, 0, -1e9]),
                         hi=np.float32([7, 7, 1e9])),
               BallFilter(center=np.float32([5, 5]),
                          radius=np.float32(4.0)),
               None)
    reqs = [RetrievalRequest(req_id=rid,
                             query_emb=rng.standard_normal(D)
                             .astype(np.float32),
                             filt=filters[rid % 3], k=(4, 9)[rid % 2])
            for rid in range(9)]
    grouped = store.retrieve_grouped(reqs)
    for r in reqs:
        solo = store.retrieve(r.query_emb, r.filt, k=r.k)[0]
        assert [d.doc_id for d in grouped[r.req_id]] == \
            [d.doc_id for d in solo]
        assert grouped[r.req_id].degraded == solo.degraded


# ---------------------------------------------------------------------------
# Value-based filter keys: equal exactly where the reference's are
# ---------------------------------------------------------------------------
def _key_cases():
    lo, hi = np.float32([0, 0, -1e9]), np.float32([8, 8, 1e9])
    box = lambda: JBox(lo=lo.copy(), hi=hi.copy())        # noqa: E731
    comp = lambda h: JCompose(box(), JInterval(          # noqa: E731
        dim=2, lo=1.0, hi=h), "and")
    return [
        (box(), 5), (box(), 5), (box(), 6), (comp(2.0), 5), (comp(2.0), 5),
        (comp(2.5), 5),
        (JBox(lo=np.float32([1, 2]), hi=np.float32([3, 4])), 5),
        (JBox(lo=np.float32([[1], [2]]), hi=np.float32([[3], [4]])), 5),
        (JBox(lo=np.int32([1, 2]), hi=np.int32([3, 4])), 5),
        (JInterval(dim=2, lo=1.0), 5), (JInterval(dim=2, lo=1.0), 5),
        (JInterval(dim=1, lo=1.0), 5), (JInterval(dim=2, hi=1.0), 5),
        (JInterval(dim=2, lo=np.float32(1.0)), 5), (None, 5), (None, 6),
        (JCompose(box(), JInterval(dim=2, lo=1.0, hi=2.0), "or"), 5),
    ]


def test_filter_key_agrees_with_reference():
    """On the reference test's cases (and a few more): two port keys are
    equal exactly where the two reference keys are."""
    cases = _key_cases()
    jk = [j_filter_key(f, k) for f, k in cases]
    tk = [_filter_key(port_filter(f), k) for f, k in cases]
    for i in range(len(cases)):
        for j in range(len(cases)):
            assert (tk[i] == tk[j]) == (jk[i] == jk[j]), (i, j)
    hash(tuple(tk))
    # a tensor leaf keys like the numpy array it holds
    t = BoxFilter(lo=torch.tensor([0.0, 1.0]), hi=torch.tensor([2.0, 3.0]))
    n = BoxFilter(lo=np.float32([0, 1]), hi=np.float32([2, 3]))
    assert _filter_key(t, 5) == _filter_key(n, 5)


def test_equal_valued_filters_batch_together():
    rng = np.random.default_rng(6)
    store = DocumentStore(_docs(rng, 150), index_cfg=CubeGraphConfig(**IDX),
                          streaming=True, stream_cfg=_stream_cfg(),
                          device="cpu")
    store.maintenance()
    calls = []
    inner = store.retrieve
    store.retrieve = lambda *a, **kw: (calls.append(1) or inner(*a, **kw))
    batcher = RetrievalBatcher(store)
    for rid in range(4):
        batcher.submit(RetrievalRequest(
            req_id=rid, query_emb=rng.standard_normal(D).astype(np.float32),
            filt=BoxFilter(lo=np.float32([0, 0, -1e9]),
                           hi=np.float32([8, 8, 1e9])), k=5))
    rows = batcher.flush()
    assert len(calls) == 1 and set(rows) == {0, 1, 2, 3}


class _FlakyStore:
    def __init__(self, bad_lo):
        self.bad_lo = bad_lo
        self.metrics = MetricsRegistry()
        self.calls = 0

    def retrieve(self, q, filt, k, ef):
        self.calls += 1
        if filt is not None and float(filt.lo) == self.bad_lo:
            raise RuntimeError("segment store offline")
        return [[("doc", i)] * k for i in range(q.shape[0])]


def test_batcher_flush_isolates_failed_chunk():
    store = _FlakyStore(bad_lo=0.5)
    batcher = RetrievalBatcher(store, ef=8)
    emb = np.ones(D, np.float32)
    good = IntervalFilter(dim=2, lo=np.float32(0.0), hi=np.float32(1.0))
    bad = IntervalFilter(dim=2, lo=np.float32(0.5), hi=np.float32(1.0))
    for i in range(6):
        batcher.submit(RetrievalRequest(req_id=i, query_emb=emb,
                                        filt=bad if i % 2 else good, k=3))
    out = batcher.flush()
    assert len(out) == 6 and len(batcher) == 0
    for i in range(6):
        if i % 2:
            assert isinstance(out[i], RetrievalFailure)
            assert "segment store offline" in out[i].error
        else:
            assert out[i] and not isinstance(out[i], RetrievalFailure)
    assert store.metrics.snapshot()["counters"]["retrieval_failed_total"] == 3
    assert store.calls == 2


def test_retrieval_batcher_deadline_and_degraded_rows():
    rng = np.random.default_rng(5)
    store = DocumentStore(_docs(rng, 200), index_cfg=CubeGraphConfig(**IDX),
                          streaming=True, stream_cfg=_stream_cfg(),
                          device="cpu")
    store.maintenance()
    batcher = RetrievalBatcher(store)
    q = rng.standard_normal(D).astype(np.float32)
    batcher.submit(RetrievalRequest(req_id=0, query_emb=q, filt=None,
                                    k=5, deadline_ms=0.0))
    batcher.submit(RetrievalRequest(req_id=1, query_emb=q, filt=None, k=5))
    rows = batcher.flush()
    assert rows[0].degraded and rows[0].reasons
    assert not rows[1].degraded and len(rows[1]) > 0


# ---------------------------------------------------------------------------
# The service: flush == solo, admission, deadlines, async loop
# ---------------------------------------------------------------------------
def test_service_flush_bit_equals_solo_retrieve():
    rng = np.random.default_rng(0)
    store = _two_tenant_store(rng)
    svc = CubeGraphService(store)
    filters = _filters()
    reqs = [ServeRequest(req_id=rid, tenant=("a", "b")[rid % 2],
                         query_emb=rng.standard_normal(D).astype(np.float32),
                         filt=filters[rid % 3], k=(5, 10)[rid % 2])
            for rid in range(12)]
    for r in reqs:
        assert svc.submit(r) is None
    answers = svc.flush()
    assert set(answers) == {r.req_id for r in reqs}
    for r in reqs:
        sr = answers[r.req_id]
        solo = store.retrieve(r.tenant, r.query_emb, r.filt, k=r.k)
        assert np.array_equal(sr.gids, solo.gids[0])
        assert np.array_equal(sr.dists, solo.dists[0])
        assert [d.doc_id for d in sr.docs] == \
            [d.doc_id for d in solo.docs[0]]
        assert not sr.degraded
        assert svc.take_result(r.req_id) is sr
    assert svc.take_result(reqs[0].req_id) is None
    st = store.stats()["tenants"]
    assert st["a"]["buckets"] and st["b"]["buckets"]


def test_service_flush_falls_back_to_solo_and_counts_it():
    """A grouped dispatch that raises is answered group by group (solo
    queries, the same answers bit for bit) and counted, so a caller can
    tell a flush that shared its reads from one that fell back."""
    rng = np.random.default_rng(1)
    store = _two_tenant_store(rng)
    svc = CubeGraphService(store)
    filters = _filters()
    reqs = [ServeRequest(req_id=rid, tenant=("a", "b")[rid % 2],
                         query_emb=rng.standard_normal(D).astype(np.float32),
                         filt=filters[rid % 3], k=5) for rid in range(6)]

    def broken(*a, **kw):
        raise RuntimeError("grouped dispatch failed")
    store.manager.query_grouped = broken
    for r in reqs:
        assert svc.submit(r) is None
    answers = svc.flush()
    counters = store.metrics.snapshot()["counters"]
    assert counters["retrieval_grouped_fallback_total"] == 1
    assert "retrieval_failed_total" not in counters
    for r in reqs:
        solo = store.retrieve(r.tenant, r.query_emb, r.filt, k=r.k)
        assert np.array_equal(answers[r.req_id].gids, solo.gids[0])
        assert np.array_equal(answers[r.req_id].dists, solo.dists[0])


def test_admission_over_quota_backpressure():
    rng = np.random.default_rng(2)
    store = _two_tenant_store(rng, n=80)
    svc = CubeGraphService(store, admission=AdmissionController(
        max_queue_per_tenant=3))
    q = rng.standard_normal(D).astype(np.float32)
    failures = [f for f in (svc.submit(ServeRequest(
        req_id=rid, tenant="a", query_emb=q)) for rid in range(5))
        if f is not None]
    assert len(failures) == 2
    assert all(f.reason == "over_quota" for f in failures)
    assert svc.take_result(failures[0].req_id).reason == "over_quota"
    snap = store.metrics.snapshot()["counters"]
    assert snap['tenant_rejected_total{tenant="a"}'] == 2
    assert svc.submit(ServeRequest(req_id=99, tenant="b",
                                   query_emb=q)) is None
    answers = svc.flush()
    assert sum(1 for v in answers.values()
               if not isinstance(v, RetrievalFailure)) == 4
    with pytest.raises(KeyError):
        svc.submit(ServeRequest(req_id=100, tenant="nobody", query_emb=q))
    glob = CubeGraphService(store, admission=AdmissionController(
        max_queue_per_tenant=64, max_queue_total=2))
    outcomes = [glob.submit(ServeRequest(req_id=i, tenant=("a", "b")[i % 2],
                                         query_emb=q)) for i in range(4)]
    assert [o is None for o in outcomes] == [True, True, False, False]


def test_deadline_degrades_only_its_own_group():
    rng = np.random.default_rng(4)
    store = _two_tenant_store(rng)
    svc = CubeGraphService(store)
    q = rng.standard_normal(D).astype(np.float32)
    svc.submit(ServeRequest(req_id=0, tenant="a", query_emb=q,
                            deadline_ms=0.0))
    svc.submit(ServeRequest(req_id=1, tenant="b", query_emb=q))
    answers = svc.flush()
    assert answers[0].degraded
    assert answers[0].reasons.get("deadline_sealed_scan", 0) >= 1
    assert not answers[1].degraded and (answers[1].gids >= 0).any()
    snap = store.metrics.snapshot()["counters"]
    assert snap['tenant_degraded_total{tenant="a"}'] == 1


def test_async_loop_answers_polled_requests():
    rng = np.random.default_rng(11)
    store = _two_tenant_store(rng, n=80)
    svc = CubeGraphService(store)
    svc.start(interval_ms=1.0)
    try:
        q = rng.standard_normal(D).astype(np.float32)
        assert svc.submit(ServeRequest(req_id=0, tenant="a", query_emb=q,
                                       k=5)) is None
        t0 = time.monotonic()
        res = None
        while res is None and time.monotonic() - t0 < 30.0:
            res = svc.take_result(0)
            if res is None:
                time.sleep(0.01)
    finally:
        svc.stop()
    assert res is not None and not isinstance(res, RetrievalFailure)
    solo = store.retrieve("a", q, None, k=5)
    assert np.array_equal(res.gids, solo.gids[0])
    assert np.array_equal(res.dists, solo.dists[0])


# ---------------------------------------------------------------------------
# Tenancy: quotas, ownership, isolation under a racing writer, snapshots
# ---------------------------------------------------------------------------
def test_quota_and_ownership_errors():
    rng = np.random.default_rng(7)
    store = MultiTenantStore(D, M, stream_cfg=_stream_cfg(), device="cpu")
    store.create_collection("a", quota_points=100)
    store.create_collection("b")
    a_gids = store.insert("a", _docs(rng, 90))
    b_gids = store.insert("b", _docs(rng, 50, base=10_000))
    with pytest.raises(TenantQuotaError):
        store.insert("a", _docs(rng, 20, base=500))
    assert store.collection("a").n_live == 90
    store.delete("a", a_gids[:40])
    store.insert("a", _docs(rng, 20, base=500))
    with pytest.raises(TenantIsolationError):
        store.delete("a", b_gids[:2])
    assert store.collection("b").n_live == 50
    with pytest.raises(TenantIsolationError):
        store.materialize("a", np.asarray([[int(b_gids[0])]]))
    with pytest.raises(ValueError):
        store.create_collection("a")


def test_concurrent_cross_tenant_race_is_invisible():
    """Tenant b inserts, deletes and runs maintenance while tenant a
    retrieves (threads drive the port only): every answer of a equals a
    dedicated single-tenant store's, bit for bit."""
    rng = np.random.default_rng(8)
    a_docs = _docs(rng, 150)
    store = MultiTenantStore(D, M, stream_cfg=_stream_cfg(), device="cpu")
    store.create_collection("a")
    store.create_collection("b")
    store.insert("a", a_docs)
    store.insert("b", _docs(rng, 100, base=10_000))
    store.maintenance()
    oracle = DocumentStore(a_docs, index_cfg=CubeGraphConfig(**IDX),
                           streaming=True, stream_cfg=_stream_cfg(),
                           device="cpu")
    oracle.maintenance()
    qs = rng.standard_normal((3, D)).astype(np.float32)
    filt = BoxFilter(lo=np.float32([0, 0, -1e9]),
                     hi=np.float32([8, 8, 1e9]))
    expect_gids, expect_dists = oracle.manager.query(qs, filt, k=10)
    expect_ids = [[a_docs[g].doc_id for g in row if g >= 0]
                  for row in np.asarray(expect_gids)]
    errors, answers = [], []
    b_rng = np.random.default_rng(9)

    def churn_b():
        try:
            for i in range(4):
                gids = store.insert(
                    "b", _docs(b_rng, 30, base=20_000 + 100 * i))
                store.delete("b", gids[::3])
                store.maintenance()
        except Exception as exc:  # noqa: BLE001 — surface in main thread
            errors.append(exc)

    def read_a():
        try:
            for _ in range(8):
                answers.append(store.retrieve("a", qs, filt, k=10))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=churn_b),
               threading.Thread(target=read_a)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors
    answers.append(store.retrieve("a", qs, filt, k=10))
    for ans in answers:
        assert np.array_equal(ans.dists, np.asarray(expect_dists,
                                                    np.float32))
        assert [[d.doc_id for d in row] for row in ans.docs] == expect_ids


def test_multi_tenant_snapshot_roundtrip(tmp_path):
    rng = np.random.default_rng(10)
    store = MultiTenantStore(D, M, stream_cfg=_stream_cfg(), device="cpu")
    store.create_collection("a", quota_points=500)
    store.create_collection("b")
    store.insert("a", _docs(rng, 120))
    b_gids = store.insert("b", _docs(rng, 80, base=10_000))
    store.delete("b", b_gids[:10])
    store.maintenance()
    q = rng.standard_normal((2, D)).astype(np.float32)
    before = store.retrieve("a", q, _filters()[0], k=8)
    store.snapshot_to(str(tmp_path / "snap"))
    restored = MultiTenantStore.restore(str(tmp_path / "snap"), D, M,
                                        device="cpu")
    after = restored.retrieve("a", q, _filters()[0], k=8)
    assert np.array_equal(before.gids, after.gids)
    assert np.array_equal(before.dists, after.dists)
    assert [[d.doc_id for d in row] for row in before.docs] == \
        [[d.doc_id for d in row] for row in after.docs]
    assert restored.collection("a").quota_points == 500
    assert restored.collection("b").n_live == 70
    assert restored.create_collection("c").tid == 3


# ---------------------------------------------------------------------------
# The traffic harness
# ---------------------------------------------------------------------------
def test_workload_smoke_report_schema():
    """The port's smoke run reports exactly the reference's keys, with
    isolation green and recall 1.0 on the exact scan path."""
    from repro.serving.workload import SLO_REPORT_KEYS as J_KEYS
    from repro_torch.serving.workload import SLO_REPORT_KEYS, _smoke
    assert SLO_REPORT_KEYS == J_KEYS
    before = b1.launch_count()
    report = _smoke(device="cpu")
    assert b1.launch_count() == before
    assert set(report) - {"latency_samples"} == set(SLO_REPORT_KEYS)
    assert report["isolation_ok"] and report["isolation_checks"] > 0
    assert report["n_requests"] > 0
    assert report["n_answered"] == report["n_requests"]
    assert report["recall_at_10"] == 1.0
