"""Port sharded pack (``repro_torch.distributed``) vs the JAX package, and
the invariants the reference keeps bit for bit inside itself.

The same numpy inputs go through ``repro`` (Pallas in interpret mode where
the list is short, its plain jnp route where an interpret-mode kernel
would unroll hundreds of argmin rounds) and ``repro_torch`` with
``device="cpu"`` (the kernels' plain twins).

Tolerances (as ``tests/test_torch_kernels.py``): fp32 distances within
``1e-5 * (|q|^2 + max |x|^2)`` per query row, since the two frameworks sum
the d products in different orders; ids equal wherever the reference's
distances are more than twice that apart from their list neighbours.  A
filter without a kernel encoding (polygon) goes through the port's single
route (rejected rows set to ``PAD_META``, same kernel) and is held to the
same tolerance.  Inside the port — shard stack vs monolithic scan,
incremental pack vs cold build, a view captured before mutations — the
distances must be equal bit for bit, and ids wherever distances are
unique.
"""
import types

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.streaming as js
from repro.core import workloads as jw
from repro.distributed import segment_shards as jss
from repro.kernels import ops as jops
import repro_torch.core as tc
import repro_torch.streaming as ts
from repro_torch.distributed import segment_shards as tss
from repro_torch.kernels import ops as tops
from test_torch_kernels import assert_topk_parity, dist_tol, port_filter

torch.set_num_threads(1)

J_IDX = jc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)
T_IDX = tc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)


def same_topk(g_a, d_a, g_b, d_b):
    """Distances equal bit for bit; gids wherever distances are unique."""
    assert np.array_equal(d_a, d_b)
    uniq = np.ones_like(g_a, bool)
    uniq[:, 1:] &= d_a[:, 1:] != d_a[:, :-1]
    uniq[:, :-1] &= d_a[:, :-1] != d_a[:, 1:]
    assert np.array_equal(g_a[uniq], g_b[uniq])


def segmented_dataset(seed, n_segments, d=32, m=3, lo=120, hi=800):
    """Random per-segment point sets with disjoint gids (the reference's
    ``tests/test_sharded.py`` recipe) as both packages' sources, plus the
    concatenated monolithic view."""
    rng = np.random.default_rng(seed)
    srcs, gid0 = [], 0
    for sid in range(n_segments):
        n = int(rng.integers(lo, hi))
        x = rng.normal(size=(n, d)).astype(np.float32)
        s = rng.uniform(size=(n, m))
        g = np.arange(gid0, gid0 + n, dtype=np.int64)
        gid0 += n
        srcs.append((sid, x, s, g, float(s[:, m - 1].min()),
                     float(s[:, m - 1].max())))
    j = [jss.SegmentShardSource(*a) for a in srcs]
    t = [tss.SegmentShardSource(*a) for a in srcs]
    x_all = np.concatenate([a[1] for a in srcs])
    s_all = np.concatenate([a[2] for a in srcs])
    g_all = np.concatenate([a[3] for a in srcs])
    return j, t, x_all, s_all, g_all


def filters(m, seed):
    yield "none", None
    yield "box", jw.make_box_filter(m, 0.4, seed=seed)
    yield "ball", jw.make_ball_filter(m, 0.5, seed=seed)
    yield "box_ball", jc.ComposeFilter(
        jw.make_ball_filter(m, 0.6, seed=seed),
        jc.IntervalFilter(dim=m - 1, lo=np.float32(0.3)), "and")
    yield "box_not_ball", jw.make_compose_filter(m, 0.5, seed=seed)
    yield "interval", jc.ComposeFilter(
        jc.BoxFilter(lo=np.zeros(m, np.float32), hi=np.ones(m, np.float32)),
        jc.IntervalFilter(dim=m - 1, lo=np.float32(0.3)), "and")
    yield "polygon", jw.make_polygon_filter(m, 0.6, seed=seed)


def _stack(seed, g=3, n=500, d=32, m=3):
    """[g, n, ·] shard stacks with ragged rows padded by PAD_META."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(g, n, d)).astype(np.float32)
    ss = rng.uniform(size=(g, n, m)).astype(np.float32)
    for gi in range(g):
        fill = int(rng.integers(n // 2, n))
        xs[gi, fill:] = 0.0
        ss[gi, fill:] = tops.PAD_META
    q = rng.normal(size=(6, d)).astype(np.float32)
    return q, xs, ss


@pytest.mark.parametrize("k", [7, 33, 300])
@pytest.mark.parametrize("name", [n for n, _ in filters(3, 0)])
def test_sharded_filtered_topk_matches_reference(name, k):
    q, xs, ss = _stack(k)
    filt = dict(filters(3, k))[name]
    ids_j, d_j = jops.sharded_filtered_topk(q, xs, ss, filt, k,
                                            use_kernel=k <= 33)
    ids_t, d_t = tops.sharded_filtered_topk(
        torch.as_tensor(q), torch.as_tensor(xs), torch.as_tensor(ss),
        port_filter(filt), k)
    assert tuple(ids_t.shape) == (3, 6, k)
    for gi in range(3):
        assert_topk_parity(ids_t[gi].numpy(), d_t[gi].numpy(),
                           np.asarray(ids_j[gi]), np.asarray(d_j[gi]),
                           dist_tol(q, xs[gi]))


def test_host_topk_bit_equal_to_reference():
    rng = np.random.default_rng(5)
    for b, w, k in ((4, 40, 10), (3, 8, 12), (5, 200, 33)):
        g = rng.integers(-1, 500, size=(b, w)).astype(np.int64)
        d = rng.integers(0, 20, size=(b, w)).astype(np.float32)  # ties
        d[rng.uniform(size=(b, w)) < 0.1] = np.inf
        gj, dj = jss.host_topk(g, d, k)
        gt, dt = tss.host_topk(g, d, k)
        assert gt.dtype == np.int64 and dt.dtype == np.float32
        assert np.array_equal(gj, gt) and np.array_equal(dj, dt)


@pytest.mark.parametrize("seed,n_segments,n_shards,k", [
    (0, 1, 1, 1), (1, 2, 3, 10), (2, 3, 2, 7), (3, 4, 4, 33),
    (4, 2, 6, 300)])
def test_shard_merge_matches_monolithic_bit_for_bit(seed, n_segments,
                                                    n_shards, k):
    """The reference's sharded-vs-single-device property inside the port,
    every filter kind including the polygon: the monolithic pack and the
    bucketed pack return the distances of one scan over all points bit
    for bit."""
    _, srcs, x_all, s_all, g_all = segmented_dataset(seed, n_segments)
    mono = tss.build_shard_pack(srcs, n_shards=n_shards, device="cpu")
    buck = tss.build_bucketed_pack(srcs, n_shards=n_shards, device="cpu")
    q = np.random.default_rng(seed + 100).normal(size=(8, 32)).astype(
        np.float32)
    for _, filt in filters(3, seed):
        f = port_filter(filt)
        mi, md = tops.filtered_topk(q, x_all, s_all, f,
                                    min(k, len(g_all)), device="cpu")
        mi, md = mi.numpy(), md.numpy()
        mg = np.where(mi >= 0, g_all[np.maximum(mi, 0)], -1)
        kk = mg.shape[1]
        for pack in (mono, buck):
            gi, di = tss.pack_search(pack, q, f, k=k)
            same_topk(gi[:, :kk], di[:, :kk], mg, md)


def test_incremental_pack_equals_cold_build():
    """Adds, removals, slot reuse and deletes keep the incrementally
    maintained pack bit for bit equal to from-scratch builds."""
    _, srcs, _, _, _ = segmented_dataset(17, 5)
    rng = np.random.default_rng(17)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    pack = tss.BucketedShardPack(n_shards=2, d=32, m=3, device="cpu")
    for src in srcs[:4]:
        pack.add_segment(src)
    assert pack.remove_segment(srcs[1].seg_id)
    assert not pack.remove_segment(999)
    pack.add_segment(srcs[4])                    # reuses the freed slot
    live = [srcs[0], srcs[2], srcs[3], srcs[4]]
    mono = tss.build_shard_pack(live, n_shards=2, device="cpu")
    cold = tss.build_bucketed_pack(live, n_shards=2, device="cpu")
    for filt in (None, tc.IntervalFilter(dim=2, lo=np.float32(0.4))):
        gi, di = tss.pack_search(pack, q, filt, k=11)
        for other in (mono, cold):
            same_topk(gi, di, *tss.pack_search(other, q, filt, k=11))
    dead = rng.choice(np.concatenate([s.gids for s in live]), 120,
                      replace=False)
    assert pack.mark_dead(dead) == mono.mark_dead(dead) \
        == cold.mark_dead(dead) == 120
    gi, di = tss.pack_search(pack, q, None, k=11)
    same_topk(gi, di, *tss.pack_search(mono, q, None, k=11))
    same_topk(gi, di, *tss.pack_search(cold, q, None, k=11))
    assert not set(gi[gi >= 0].tolist()) & set(dead.tolist())


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_view_before_mutation_keeps_answering_old_state(quantize):
    """Copy-on-write: a view captured before add_segment and mark_dead
    returns the pre-mutation answer, bit for bit."""
    _, srcs, x_all, _, _ = segmented_dataset(3, 3, lo=300, hi=400)
    pack = tss.build_bucketed_pack(srcs[:2], n_shards=2, quantize=quantize,
                                   device="cpu")
    q = x_all[:4] + 0.01            # nearest neighbours are known points
    view = pack.view()
    before = tss.pack_search_blocks(view, q, None, k=6)
    hits = np.concatenate([b[0] for b in before], axis=1)
    assert pack.mark_dead(hits[hits >= 0]) > 0
    pack.add_segment(srcs[2])
    after = tss.pack_search_blocks(view, q, None, k=6)
    for (g0, d0), (g1, d1) in zip(before, after):
        assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    fresh = np.concatenate(
        [b[0] for b in tss.pack_search_blocks(pack.view(), q, None, k=6)],
        axis=1)
    assert not set(fresh[fresh >= 0].tolist()) & set(hits[hits >= 0]
                                                      .tolist())


def test_bucket_geometry_matches_reference():
    """Same sources -> same capacity classes, rows and occupancy."""
    jsrc, tsrc, _, _, _ = segmented_dataset(23, 5, lo=100, hi=1500)
    jp = jss.build_bucketed_pack(jsrc, n_shards=2)
    tp = tss.build_bucketed_pack(tsrc, n_shards=2, device="cpu")
    assert jp.bucket_stats() == tp.bucket_stats()
    for sid in (1, 3):
        assert jp.remove_segment(sid) and tp.remove_segment(sid)
    assert jp.bucket_stats() == tp.bucket_stats()
    assert [jss.bucket_cap_for(n, 3) for n in (1, 700, 5000)] == \
        [tss.bucket_cap_for(n, 3) for n in (1, 700, 5000)]
    # a mesh on an explicit device tuple: the reference's geometry (its
    # mesh here has the worker's one device; its slot rule is checked on
    # a stand-in mesh of each size)
    mesh = tss.ShardMesh(("cpu",))
    assert tss.build_bucketed_pack(tsrc, n_shards=2, mesh=mesh) \
        .bucket_stats() == jss.build_bucketed_pack(
            jsrc, n_shards=2, mesh=jss.make_shard_mesh(1)).bucket_stats()
    for nd in (1, 2, 3, 4):
        stand_in = types.SimpleNamespace(devices=np.empty(nd))
        for ns in range(1, 7):
            tp_nd = tss.BucketedShardPack(ns, 8, 3,
                                          mesh=tss.ShardMesh(("cpu",) * nd))
            jp_nd = jss.BucketedShardPack(ns, 8, 3, mesh=stand_in)
            assert tp_nd._init_slots() == jp_nd._init_slots()


def _timed(n, d=24, seed=0):
    x, s = jw.make_dataset(n, d, 3, seed=seed)
    s[:, 2] = np.arange(n) / n
    return x, s


def _window(lo, hi):
    return jc.ComposeFilter(
        jc.BoxFilter(lo=np.zeros(3, np.float32), hi=np.ones(3, np.float32)),
        jc.IntervalFilter(dim=2, lo=np.float32(lo), hi=np.float32(hi)),
        "and")


@pytest.mark.parametrize("incremental", [True, False])
def test_manager_sharded_matches_reference_on_tape(incremental):
    """Both managers with n_shards=2 on the same ingest / delete / expire /
    compact tape: identical lifecycle state and pack geometry, exact
    answers within the fp32 tolerance, ids equal where unique."""
    n = 2400
    x, s = _timed(n)
    kw = dict(time_dim=2, seal_max_points=500, n_shards=2, ttl=0.6,
              compact_max_segments=3, incremental_pack=incremental,
              pack_warm_compile=False)
    jm = js.SegmentManager(24, 3, js.StreamConfig(**kw, index_cfg=J_IDX))
    tm = ts.SegmentManager(24, 3, ts.StreamConfig(**kw, index_cfg=T_IDX),
                           device="cpu")
    rng = np.random.default_rng(9)
    q = (x[rng.integers(0, n, 8)]
         + 0.05 * rng.normal(size=(8, 24)).astype(np.float32))
    for lo in range(0, n, 600):
        for m in (jm, tm):
            m.ingest(x[lo:lo + 600], s[lo:lo + 600])
        if lo == 1200:
            dead = rng.choice(lo, size=150, replace=False)
            assert jm.delete(dead) == tm.delete(dead)
        if lo == 1800:
            assert jm.expire() == tm.expire()
        for f in (None, _window(0.3, 0.9)):
            g_j, d_j = jm.query(q, f, k=10)
            g_t, d_t = tm.query(q, port_filter(f), k=10)
            assert_topk_parity(g_t, d_t, g_j, d_j, dist_tol(q, x))
        st_j, st_t = jm.stats(), tm.stats()
        for key in ("n_live", "n_segments", "segment_live", "epoch",
                    "pack_buckets"):
            assert st_j[key] == st_t[key], key
    assert jm.compact() == tm.compact()
    g_j, d_j = jm.query(q, _window(0.5, 1.0), k=10)
    g_t, d_t = tm.query(q, port_filter(_window(0.5, 1.0)), k=10)
    assert_topk_parity(g_t, d_t, g_j, d_j, dist_tol(q, x))
    assert jm.stats()["pack_buckets"] == tm.stats()["pack_buckets"]
    # exact path: ground truth over the live points
    gt, _ = jw.ground_truth(x, s, q, _window(0.5, 1.0), 10, valid=jm.alive)
    assert jw.recall(g_t, gt) >= 0.999


def test_warming_loads_libraries_only_on_the_card():
    """Warming builds and loads the pack's kernels and replays nothing; a
    CPU pack runs the twins, so nothing is loaded and a seal warms
    nothing."""
    assert tops.warm_sharded_shapes("fp32", "cpu") == 0
    assert tops.warm_sharded_shapes("int8", torch.device("cpu"),
                                    graph=True) == 0
    assert not tops.kernels_loaded("fp32")
    assert not tops.kernels_loaded("int8")
    x, s = _timed(300)
    mgr = ts.SegmentManager(24, 3, ts.StreamConfig(
        time_dim=2, seal_max_points=100, n_shards=2, index_cfg=T_IDX),
        device="cpu")
    mgr.ingest(x, s)
    mgr.maintenance()
    assert mgr.stats()["sealed"] >= 1
    assert mgr._warm_pack() == 0
