"""Port streaming path (``repro_torch.streaming``) vs the JAX package.

Both ``SegmentManager``s are driven with the same op tapes as
``tests/test_streaming.py`` (ingest, seal, delete, TTL expiry, compaction,
point-store GC); the port runs with ``device="cpu"``.  Lifecycle state must
be identical, and query answers agree on >= 99% of result slots with
distances within ``1e-5 * (|q|^2 + max |x|^2)`` (fp32 sums in another
order).  ``recall`` keeps the reference's semantics: an empty ground truth
counts 0, so legs with no qualifying point assert parity, not a bound.
"""
import dataclasses
import gc
import json
import threading

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.streaming as js
from repro.core import workloads as jw
import repro_torch.core as tc
import repro_torch.streaming as ts
from repro_torch.core import workloads as tw
from test_torch_kernels import dist_tol, port_filter

torch.set_num_threads(1)

J_IDX = jc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)
T_IDX = tc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)


def _timed_dataset(n, d=24, m=3, seed=0):
    x, s = jw.make_dataset(n, d, m, seed=seed)
    s[:, m - 1] = np.arange(n) / n
    return x, s


def _queries(x, b=8, seed=2):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, len(x), b)]
            + 0.05 * rng.normal(size=(b, x.shape[1])).astype(np.float32))


def _window(t_lo, t_hi):
    return jc.ComposeFilter(
        jc.BoxFilter(lo=np.zeros(3, np.float32), hi=np.ones(3, np.float32)),
        jc.IntervalFilter(dim=2, lo=np.float32(t_lo), hi=np.float32(t_hi)),
        "and")


def _pair(**kw):
    idx = kw.pop("idx", True)
    jm = js.SegmentManager(24, 3, js.StreamConfig(
        **kw, **({"index_cfg": J_IDX} if idx else {})))
    tm = ts.SegmentManager(24, 3, ts.StreamConfig(
        **kw, **({"index_cfg": T_IDX} if idx else {})), device="cpu")
    return jm, tm


def _state(m):
    st = m.stats()
    keys = ("n_total", "n_live", "delta_live", "n_segments", "segment_live",
            "segment_spans", "epoch", "sealed", "compactions",
            "expired_segments", "expired_points", "deleted",
            "store_gc_points", "store_resident_points")
    return {k: st[k] for k in keys}


def _assert_answers(jm, tm, q, x, f, k=10, ef=96):
    g_j, d_j = jm.query(q, f, k=k, ef=ef)
    g_t, d_t = tm.query(q, port_filter(f), k=k, ef=ef)
    assert g_t.dtype == np.int64 and d_t.dtype == np.float32
    assert g_t.shape == g_j.shape
    same = g_t == g_j
    assert same.mean() >= 0.99, same.mean()
    fin = np.isfinite(d_j) & same
    assert np.all(np.abs(np.where(fin, d_t, 0) - np.where(fin, d_j, 0))
                  <= dist_tol(q, x))
    return g_t, d_t


def test_op_tape_parity():
    """tests/test_streaming.py::test_fanout_matches_monolithic's tape:
    interleaved ingest / seal / delete / expire, then mixed fan-out
    queries; plus compaction and GC."""
    n = 3000
    x, s = _timed_dataset(n)
    jm, tm = _pair(time_dim=2, seal_max_points=700, ttl=0.5,
                   compact_max_segments=3, store_chunk=256)
    rng = np.random.default_rng(7)
    for lo in range(0, n, 300):
        for m in (jm, tm):
            m.ingest(x[lo:lo + 300], s[lo:lo + 300])
        if lo == 1500:
            dead = rng.choice(lo, size=200, replace=False)
            assert jm.delete(dead) == tm.delete(dead)
        if lo == 2100:
            assert jm.expire() == tm.expire()
        assert _state(jm) == _state(tm)
    assert len(tm.segments) >= 2 and tm.delta.n_live > 0
    q = _queries(x)
    for f in (_window(0.55, 0.95), None,
              jc.IntervalFilter(dim=2, lo=np.float32(0.6)),
              jw.make_ball_filter(3, 0.2, seed=1)):
        _assert_answers(jm, tm, q, x, f)
    assert jm.compact() == tm.compact()
    assert jm.gc_store() == tm.gc_store()
    assert _state(jm) == _state(tm)
    np.testing.assert_array_equal(jm.alive, tm.alive)
    _assert_answers(jm, tm, q, x, _window(0.55, 0.95))
    gt, _ = tw.ground_truth(x, s, q, port_filter(_window(0.55, 0.95)), 10,
                            valid=tm.alive)
    assert tw.recall(tm.query(q, port_filter(_window(0.55, 0.95)), k=10,
                              ef=128)[0], gt) >= 0.95


def test_maintenance_tape_parity():
    """Seal / expire / compact / GC ticks with deletes in between."""
    x, s = _timed_dataset(1000)
    jm, tm = _pair(time_dim=2, seal_max_points=200, ttl=0.6,
                   compact_max_segments=3, compact_deleted_fraction=0.2,
                   store_chunk=128)
    rng = np.random.default_rng(3)
    for lo in range(0, 1000, 200):
        for m in (jm, tm):
            m.ingest(x[lo:lo + 200], s[lo:lo + 200])
        dead = rng.choice(lo + 200, size=40, replace=False)
        assert jm.delete(dead) == tm.delete(dead)
        assert jm.maintenance() == tm.maintenance()
        assert _state(jm) == _state(tm)
    _assert_answers(jm, tm, _queries(x), x, None)


def test_merge_topk_bit_equal():
    rng = np.random.default_rng(0)
    blocks_g, blocks_d = [], []
    for i in range(4):
        g = rng.permutation(1000)[:12].reshape(1, 12).repeat(5, 0) + i * 1000
        d = rng.integers(0, 6, size=(5, 12)).astype(np.float32)   # ties
        g[:, -2:] = -1
        d[:, -2:] = np.inf
        blocks_g.append(g.astype(np.int64))
        blocks_d.append(d)
    for k in (1, 7, 10, 60):
        gj, dj = js.merge_topk(blocks_g, blocks_d, k)
        gt_, dt_ = ts.merge_topk(blocks_g, blocks_d, k)
        assert gt_.dtype == gj.dtype and dt_.dtype == dj.dtype
        assert np.array_equal(gt_, gj) and np.array_equal(dt_, dj)


def test_temporal_bounds_match_reference():
    for f in (None, _window(0.2, 0.7),
              jc.IntervalFilter(dim=2, lo=np.float32(0.3)),
              jc.IntervalFilter(dim=1, hi=np.float32(0.3)),
              jw.make_ball_filter(3, 0.1, seed=2)):
        for dim in (1, 2):
            assert ts.temporal_bounds(port_filter(f), dim) == \
                js.temporal_bounds(f, dim)


def test_empty_ground_truth_keeps_reference_recall():
    """A window no live point satisfies: both managers answer all -1 and
    both recalls are the reference's 0.0 for an empty ground truth."""
    x, s = _timed_dataset(600)
    jm, tm = _pair(time_dim=2, seal_max_points=200)
    jm.ingest(x, s)
    tm.ingest(x, s)
    f = jc.IntervalFilter(dim=2, lo=np.float32(2.0))
    q = _queries(x)
    g_t, _ = _assert_answers(jm, tm, q, x, f)
    assert np.all(g_t == -1)
    gt_j, _ = jw.ground_truth(x, s, q, f, 10)
    gt_t, _ = tw.ground_truth(x, s, q, port_filter(f), 10)
    assert np.array_equal(gt_j, gt_t) and np.all(gt_t == -1)
    assert tw.recall(g_t, gt_t) == jw.recall(g_t, gt_j) == 0.0


def test_seal_prune_and_halfopen_window():
    cfg = ts.StreamConfig(time_dim=2, seal_max_points=500, index_cfg=T_IDX)
    x, s = _timed_dataset(1750)
    mgr = ts.SegmentManager(24, 3, cfg, device="cpu")
    for lo in range(0, 1750, 250):
        mgr.ingest(x[lo:lo + 250], s[lo:lo + 250])
        assert mgr.delta.n_live < cfg.seal_max_points
    assert len(mgr.segments) == 3 and mgr.delta.n_live == 250
    f = tc.IntervalFilter(dim=2, lo=np.float32(0.8))
    ids, _, stats = mgr.query(_queries(x), f, k=10, ef=96,
                              return_stats=True)
    pruned = [t for t in stats if t.pruned]
    assert pruned and all(t.t_max < 0.8 for t in pruned)
    assert np.all(s[ids[ids >= 0], 2] >= 0.8)
    gt, _ = tw.ground_truth(x, s, _queries(x), f, 10)
    assert tw.recall(ids, gt) >= 0.9


def test_concurrent_compaction_never_returns_stale_points():
    cfg = ts.StreamConfig(time_dim=2, seal_max_points=250,
                          compact_max_segments=2,
                          compact_deleted_fraction=0.2, index_cfg=T_IDX)
    x, s = _timed_dataset(1500)
    mgr = ts.SegmentManager(24, 3, cfg, device="cpu")
    mgr.ingest(x, s)
    dead = np.random.default_rng(9).choice(1500, size=500, replace=False)
    mgr.delete(dead)
    dead_set = set(dead.tolist())
    q = _queries(x)
    t = mgr.compact_async()
    assert t is mgr.compact_async()
    violations = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            ids, _ = mgr.query(q, None, k=10, ef=64)
            got = ids[ids >= 0]
            if set(got.tolist()) & dead_set or (~mgr.alive[got]).any():
                violations.append(got)

    w = threading.Thread(target=hammer)
    w.start()
    mgr.wait_for_compaction()
    stop.set()
    w.join()
    assert not violations
    assert len(mgr.segments) <= cfg.compact_max_segments
    assert mgr.stats()["health"]["compactor"]["runs"] == 1


def test_stats_trace_and_deadline():
    x, s = _timed_dataset(900)
    mgr = ts.SegmentManager(24, 3, ts.StreamConfig(
        time_dim=2, seal_max_points=300, index_cfg=T_IDX), device="cpu")
    mgr.ingest(x, s)
    out = mgr.query(_queries(x), None, k=5, return_trace=True)
    g, d, trace = out
    assert not out.degraded
    names = [sp["name"] for sp in trace.to_dict()["spans"]]
    assert names[0] == "snapshot" and "segment_scan" in names
    assert names[-1] == "merge"
    res = mgr.query(_queries(x), None, k=5, deadline_ms=0.0)
    assert res.degraded and res.reasons.get("deadline_segment", 0) >= 1
    st = mgr.stats()
    json.dumps(st, allow_nan=False)
    assert st["obs"]["metrics"]["counters"]["query_batches_total"] == 2


def _spans(node, name):
    """Every span called ``name`` in a trace tree, in start order."""
    out = [node] if node.get("name") == name else []
    for c in node.get("spans", ()):
        out += _spans(c, name)
    return out


def _children(node):
    return [c["name"] for c in node.get("spans", ())]


def _covered(node):
    """Share of a span's ms its children account for."""
    return sum(c["ms"] for c in node["spans"]) / node["ms"]


def _nested(node):
    for c in node.get("spans", ()):
        assert node["start_ns"] <= c["start_ns"] <= c["end_ns"] \
            <= node["end_ns"], (node["name"], c["name"])
        _nested(c)


def _counters(mgr):
    return dict(mgr.obs.registry.snapshot()["counters"])


def _h2d(diff, site):
    return diff.get(f'h2d_bytes_total{{site="{site}"}}', 0)


def _span_manager(quantize, n_shards):
    """3,200 rows ingested in batches of 700, sealed every 500: six
    segments in the pack, 200 rows left in the delta buffer."""
    x, s = _timed_dataset(3200)
    mgr = ts.SegmentManager(24, 3, ts.StreamConfig(
        time_dim=2, seal_max_points=500, seal_max_age=1e9,
        n_shards=n_shards, quantize=quantize, index_cfg=T_IDX),
        device="cpu")
    for lo in range(0, 3200, 700):
        mgr.ingest(x[lo:lo + 700], s[lo:lo + 700])
        mgr.maintenance()
    box = tc.BoxFilter(lo=np.array([0.1, 0.1, 0.2], np.float32),
                       hi=np.array([0.9, 0.9, 1.0], np.float32))
    return mgr, _queries(x, b=1200), box


@pytest.mark.parametrize("quantize,n_shards", [
    (None, 1), (None, 2), ("int8", 1), ("int8", 2)])
def test_query_spans_and_copy_counters(quantize, n_shards):
    """The spans inside the sealed scan, the int8 rerank and the merge:
    present, nested, covering their parents; answers bit for bit those of
    an untraced query; ``h2d_bytes_total`` per site and the rerank's
    counters equal what the shapes and the candidates give."""
    k, d, m = 50, 24, 3
    mgr, q, box = _span_manager(quantize, n_shards)
    assert mgr.delta.n_live == 200
    plain = mgr.query(q, box, k=k)               # untraced, warms the path
    looked_up = []
    get_points = mgr.get_points

    def spy(gids):
        looked_up.append(len(gids))
        return get_points(gids)
    mgr.get_points = spy
    before = _counters(mgr)
    g, dd, trace = mgr.query(q, box, k=k, return_trace=True)
    after = _counters(mgr)
    diff = {n: after[n] - before.get(n, 0) for n in after}
    assert np.array_equal(plain[0], g) and np.array_equal(plain[1], dd)

    tree = trace.to_dict()
    assert tree["id"] == 1                       # the manager's 2nd batch
    _nested(tree)
    assert {"snapshot", "delta_scan", "sealed_scan", "merge"} \
        <= set(_children(tree))
    sealed, = _spans(tree, "sealed_scan")
    names = _children(sealed)
    assert names[0] == "queries_upload"
    dispatches = _spans(sealed, "bucket_dispatch")
    assert dispatches and names[1:len(dispatches) + 1] == \
        ["bucket_dispatch"] * len(dispatches)
    for bd in dispatches:
        assert _children(bd) == ["bucket_fetch"]
    merge, = _spans(tree, "merge")
    assert _children(merge) == ["merge_topk", "alive_filter"]
    assert _covered(merge) >= 0.95, merge

    b = q.shape[0]
    delta, = _spans(tree, "delta_scan")
    n_delta = delta["attrs"]["rows"]
    assert _h2d(diff, "delta") == 4 * (b * d + n_delta * (d + m))
    assert _h2d(diff, "scan_queries") == q.nbytes
    # the delta scan's filter block [4, m] fp32, then a bucket's active
    # mask (a byte a row) and its filter, per launch
    other = 16 * m + sum(bd["attrs"]["rows"] + 16 * m for bd in dispatches)
    assert _h2d(diff, "cold_stage") == 0
    if quantize is None:
        assert names[-1] == "bucket_dispatch"
        assert not _spans(tree, "rerank_fp32") and not looked_up
        assert diff.get("rerank_candidates_total", 0) == 0
        assert _h2d(diff, "other") == other
        return
    rerank, = _spans(sealed, "rerank_fp32")
    assert names[-1] == "rerank_fp32"
    assert _children(rerank) == ["rerank_lookup", "rerank_upload",
                                 "rerank_score", "rerank_topk"]
    assert _covered(rerank) >= 0.95, rerank
    n_cand = sum(bd["attrs"]["candidates"] for bd in dispatches)
    lookup, = _spans(rerank, "rerank_lookup")
    assert looked_up == [lookup["attrs"]["rows"]]
    assert diff["rerank_candidates_total"] == n_cand \
        == lookup["attrs"]["candidates"]
    assert diff["rerank_rows_total"] == looked_up[0] <= n_cand
    assert _h2d(diff, "rerank_queries") == q.nbytes
    assert _h2d(diff, "rerank_rows") == looked_up[0] * d * 4
    # the rerank's positions [b, overfetch] int32 and its filter block
    other += b * rerank["attrs"]["overfetch"] * 4 + 32
    assert _h2d(diff, "other") == other


def test_untraced_query_opens_no_span(monkeypatch):
    """Tracing off, the query path creates no span, and the disabled
    spans and the counters it calls allocate nothing that stays."""
    import tracemalloc
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.metrics import count_h2d
    mgr, q, box = _span_manager("int8", 2)
    made = []
    init = obs_trace.Span.__init__

    def counting(self, *a, **kw):
        made.append(a)
        init(self, *a, **kw)
    monkeypatch.setattr(obs_trace.Span, "__init__", counting)
    mgr.query(q[:64], box, k=10)
    before = _counters(mgr)
    mgr.query(q[:64], box, k=10)
    assert not made
    after = _counters(mgr)
    assert after['h2d_bytes_total{site="rerank_queries"}'] \
        - before['h2d_bytes_total{site="rerank_queries"}'] == q[:64].nbytes
    reg = mgr.obs.registry
    trace = obs_trace.NULL_TRACE

    def disabled_calls():
        for name in ("rerank_lookup", "rerank_upload", "rerank_score",
                     "rerank_topk", "merge_topk", "alive_filter",
                     "queries_upload", "bucket_fetch"):
            with trace.span(name) as sp:
                if trace.enabled:
                    sp.annotate(rows=1)
        count_h2d(reg, "other", 48)
        reg.counter("rerank_rows_total").inc(3)
    disabled_calls()
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    for _ in range(1000):
        disabled_calls()
    snap1 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(st.size_diff for st in snap1.compare_to(snap0, "filename")
                if st.size_diff > 0 and "repro_torch" in
                st.traceback[0].filename)
    assert grown < 1024, f"the disabled path kept {grown} bytes"
    assert not made


def test_span_clock_matches_the_profiler(tmp_path):
    """A span's ``start_ns`` / ``end_ns`` lie within 1 ms of its
    ``record_function`` range in an exported CPU profile (Chrome trace:
    ``ts`` is microseconds after ``baseTimeNanoseconds``)."""
    from torch.profiler import ProfilerActivity, profile
    mgr, q, box = _span_manager("int8", 1)
    mgr.query(q[:64], box, k=10)
    gc.disable()                   # no collector's pause between the two
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tree = mgr.query(q[:64], box, k=10,
                             return_trace=True)[-1].to_dict()
    finally:
        gc.enable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    ranges: dict = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = base + float(e["ts"]) * 1e3
            ranges.setdefault(e["name"], []).append(
                (a, a + float(e["dur"]) * 1e3))
    seen = 0
    for name in ("query", "sealed_scan", "bucket_dispatch", "rerank_fp32",
                 "rerank_lookup", "rerank_upload", "rerank_score",
                 "rerank_topk", "merge", "merge_topk", "alive_filter"):
        spans = _spans(tree, name)
        assert spans and len(spans) == len(ranges[name]), name
        for sp, (a, b) in zip(spans, sorted(ranges[name])):
            assert abs(sp["start_ns"] - a) < 1e6, (name, sp["start_ns"], a)
            assert abs(sp["end_ns"] - b) < 1e6, (name, sp["end_ns"], b)
            seen += 1
    assert seen >= 11


@pytest.mark.parametrize("kw,item", [
    ({"n_shards": 1}, None), ({"n_shards": 1, "quantize": "int8"}, None),
    ({"n_shards": 1, "read_path": "graph"}, None),
    ({"persist_dir": "home"}, "item 8"),
    ({"device_budget_bytes": 0}, "item 9")])
def test_later_slice_options_raise(kw, item, tmp_path):
    """The sharded, int8 and graph read paths (items 5-7), persistence
    (item 8) and tiering (item 9) are ported: their options are accepted,
    and they raise only where the reference does (a budget without the
    sharded pack)."""
    if item is None:
        mgr = ts.SegmentManager(8, 2, ts.StreamConfig(**kw), device="cpu")
        assert mgr.cfg.n_shards == 1
        return
    if item == "item 8":
        root = str(tmp_path / kw["persist_dir"])
        mgr = ts.SegmentManager(8, 2, ts.StreamConfig(persist_dir=root),
                                device="cpu")
        assert mgr.persist is not None
        assert ts.load_manifest(root)["n_total"] == 0
        return
    with pytest.raises(ValueError, match="sharded incremental pack"):
        ts.SegmentManager(8, 2, ts.StreamConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="sharded incremental pack"):
        js.SegmentManager(8, 2, js.StreamConfig(**kw))
    mgr = ts.SegmentManager(8, 2, ts.StreamConfig(n_shards=1, **kw),
                            device="cpu")
    assert mgr.tier is not None and mgr.tier.budget_bytes == 0


def test_later_slice_entry_points_raise(tmp_path):
    mgr = ts.SegmentManager(8, 2, ts.StreamConfig(), device="cpu")
    # resilience (item 10) is ported: an injector installs and uninstalls
    inj = ts.FaultInjector()
    mgr.install_fault_injector(inj)
    assert mgr.fault_injector is inj
    mgr.install_fault_injector(None)
    assert mgr.fault_injector is None
    # persistence (item 8) is ported: an empty manager snapshots
    assert mgr.snapshot_to(str(tmp_path / "x"))["n_total"] == 0
    # grouped queries (item 11) are ported: empty batches answer empty
    assert mgr.query_grouped([]) == []
    from repro_torch.distributed import PackView, pack_search_blocks_grouped
    from repro_torch.kernels.ops import sharded_filtered_topk_grouped
    view = PackView(epoch=0, n_shards=1, m=2, buckets=(), nbytes=0)
    assert pack_search_blocks_grouped(view, []) == []
    assert sharded_filtered_topk_grouped(
        [], torch.zeros(1, 4, 8), torch.zeros(1, 4, 2)) == []
    # the sharded path (ported) answers an empty manager with padding
    for kw in ({"use_shards": True}, {"read_path": "auto"}):
        g, d = mgr.query(np.zeros((1, 8), np.float32), None, k=3, **kw)
        assert (g == -1).all() and np.isinf(d).all()
    # StreamConfig keeps every reference field with the same default
    tj, tt = js.StreamConfig(), ts.StreamConfig()
    names = [f.name for f in dataclasses.fields(js.StreamConfig)]
    assert [f.name for f in dataclasses.fields(ts.StreamConfig)] == names
    for name in names:
        if name != "index_cfg":
            assert getattr(tt, name) == getattr(tj, name), name
    assert dataclasses.asdict(tt.index_cfg) == dataclasses.asdict(
        tj.index_cfg)
