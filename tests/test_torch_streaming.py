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
    with pytest.raises(NotImplementedError, match="item 10"):
        mgr.install_fault_injector(None)
    # persistence (item 8) is ported: an empty manager snapshots
    assert mgr.snapshot_to(str(tmp_path / "x"))["n_total"] == 0
    with pytest.raises(NotImplementedError, match="item 11"):
        mgr.query_grouped([])
    from repro_torch.distributed import pack_search_blocks_grouped
    from repro_torch.kernels.ops import sharded_filtered_topk_grouped
    with pytest.raises(NotImplementedError, match="item 11"):
        pack_search_blocks_grouped(None, [])
    with pytest.raises(NotImplementedError, match="item 11"):
        sharded_filtered_topk_grouped([], None, None)
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
