"""Port quantized read path (``repro_torch.quant``, kernel B3's twin) vs
the JAX package, and the quantized invariants inside the port.

- The codec is host numpy in both packages: codes, scales and ``xsq`` must
  be equal bit for bit, and ``|x - scale * code| <= scale / 2`` holds.
- B3's twin (``quant_topk_plain``) against the reference's
  ``quant_filtered_topk_kernel_call`` in interpret mode, built from the
  same codes in each package's own layout (row-major here, transposed
  there): partial distances within ``1e-5 * (|q|^2 + max |x|^2)`` (the
  frameworks sum in different orders), ids equal wherever distances are
  more than twice that apart.
- Inside the port, bit for bit: a quantized incrementally maintained pack
  and a cold rebuild answer identically; exact distance ties after the
  fp32 rerank order by gid.  With an over-fetch covering every point the
  two-stage answer recovers the fp32 path's gids (distances within 1e-4,
  the reference's own bound: the rerank and the scan are different
  summations).
"""
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.quant as jq
import repro.streaming as js
from repro.core import workloads as jw
from repro.kernels import ops as jops
from repro.kernels.quant_topk import quant_filtered_topk_kernel_call
import repro_torch.core as tc
import repro_torch.quant as tq
import repro_torch.streaming as ts
from repro_torch.distributed import segment_shards as tss
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quant_topk import quant_topk_plain
from test_torch_kernels import assert_topk_parity, dist_tol, port_filter

torch.set_num_threads(1)

J_IDX = jc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)
T_IDX = tc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)


@pytest.mark.parametrize("seed,n,d,spread", [(0, 200, 16, 1.0),
                                             (1, 57, 33, 1e-3),
                                             (2, 500, 24, 300.0)])
def test_codec_bit_equal_and_scale_bound(seed, n, d, spread):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * spread).astype(np.float32)
    x[:, d // 2] = 0.0                    # an all-zero dimension
    a, b = jq.encode_segment(x), tq.encode_segment(x)
    for name in ("codes", "scales", "xsq"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).dtype == getattr(b, name).dtype
    assert np.array_equal(jq.fit_scales(x), tq.fit_scales(x))
    assert np.array_equal(jq.quantize(x, b.scales), tq.quantize(x, b.scales))
    deq = tq.dequantize(b.codes, b.scales)
    assert np.array_equal(deq, jq.dequantize(a.codes, a.scales))
    assert (np.abs(x - deq) <= b.scales[None, :] / 2).all()
    assert (deq[:, d // 2] == 0.0).all()
    sub = b.take(np.arange(0, n, 3))
    assert sub.n == len(range(0, n, 3)) and sub.scales is b.scales
    with pytest.raises(ValueError):
        tq.encode_segment(x, "int4")


def _quant_block(seed, n=700, d=32, m=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.uniform(size=(n, m)).astype(np.float32)
    sq = jq.encode_segment(x)
    q = rng.normal(size=(5, d)).astype(np.float32)
    return q, x, s, sq


_KINDS = {
    "none": None,
    "box": jw.make_box_filter(3, 0.5, seed=3),
    "ball": jc.BallFilter(center=np.asarray([0.5, 0.5]), radius=0.35),
    "box_ball": jc.ComposeFilter(
        jw.make_ball_filter(3, 0.6, seed=3),
        jc.IntervalFilter(dim=2, lo=np.float32(0.3)), "and"),
    "box_not_ball": jw.make_compose_filter(3, 0.5, seed=3),
}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", list(_KINDS))
def test_b3_twin_matches_reference_kernel(kind, metric):
    """quant_topk_plain vs the Pallas kernel (interpret mode) from the same
    codes: partial L2 (no |q|^2) or -ip, the same predicate."""
    q, _, s, sq = _quant_block(11)
    n, d = sq.codes.shape
    kpad = 16
    got_kind, params = jops.encode_filter(_KINDS[kind], 3)
    assert got_kind == kind
    qs = q * sq.scales[None, :]
    # reference layout: transposed codes / metadata + xsq sublane
    dq, mq, npad = 32, jops.quant_meta_rows(3), 768
    codes_t = np.zeros((dq, npad), np.int8)
    codes_t[:d, :n] = sq.codes.T
    st = np.full((mq, npad), tops.PAD_META, np.float32)
    st[:, :n] = 0.0
    st[:3, :n] = s.T
    st[mq - 1, :n] = sq.xsq
    qsp = np.zeros((8, dq), np.float32)
    qsp[:5, :d] = qs
    dj, ij = quant_filtered_topk_kernel_call(
        qsp, codes_t, st, params[:, :mq], kind=kind, kpad=kpad,
        metric=metric, tq=8, interpret=True)
    pt = torch.as_tensor(tops.encode_filter(port_filter(_KINDS[kind]), 3,
                                            mpad=3)[1])
    dt, it = quant_topk_plain(torch.as_tensor(qs)[None],
                              torch.as_tensor(sq.codes)[None],
                              torch.as_tensor(s)[None],
                              torch.as_tensor(sq.xsq)[None], pt, kind, kpad,
                              metric)
    deq = jq.dequantize(sq.codes, sq.scales)
    assert_topk_parity(it[0].numpy(), dt[0].numpy(), np.asarray(ij)[:5],
                       np.asarray(dj)[:5], dist_tol(q, deq))


@pytest.mark.parametrize("k", [5, 17])
@pytest.mark.parametrize("name", ["none", "box", "interval", "polygon"])
def test_sharded_quant_wrapper_matches_reference(name, k):
    """Stacks of several shard rows, each with its own scales; the polygon
    goes through the port's single route."""
    rng = np.random.default_rng(k)
    g, n, d, m = 3, 400, 32, 3
    filt = {"none": None, "box": jw.make_box_filter(3, 0.5, seed=k),
            "interval": jc.ComposeFilter(
                jc.BoxFilter(lo=np.zeros(3, np.float32),
                             hi=np.ones(3, np.float32)),
                jc.IntervalFilter(dim=2, lo=np.float32(0.4)), "and"),
            "polygon": jw.make_polygon_filter(3, 0.6, seed=k)}[name]
    codes = np.zeros((g, n, d), np.int8)
    s = np.full((g, n, m), tops.PAD_META, np.float32)
    xsq = np.zeros((g, n), np.float32)
    scales = np.zeros((g, d), np.float32)
    dq, mq = 32, jops.quant_meta_rows(m)
    codes_t = np.zeros((g, dq, n), np.int8)
    st = np.full((g, mq, n), tops.PAD_META, np.float32)
    deqs = []
    for gi in range(g):
        fill = int(rng.integers(n // 2, n))
        sq = jq.encode_segment(rng.normal(size=(fill, d)).astype(np.float32))
        codes[gi, :fill] = sq.codes
        s[gi, :fill] = rng.uniform(size=(fill, m))
        xsq[gi, :fill] = sq.xsq
        scales[gi] = sq.scales
        codes_t[gi, :, :fill] = sq.codes.T
        st[gi, :, :fill] = 0.0
        st[gi, :m, :fill] = s[gi, :fill].T
        st[gi, mq - 1, :fill] = sq.xsq
        deqs.append(jq.dequantize(sq.codes, sq.scales))
    q = rng.normal(size=(6, d)).astype(np.float32)
    ij, dj = jops.sharded_quant_filtered_topk(q, codes_t, st, scales, filt,
                                              k, m=m)
    it, dt = tops.sharded_quant_filtered_topk(
        torch.as_tensor(q), torch.as_tensor(codes), torch.as_tensor(s),
        torch.as_tensor(xsq), torch.as_tensor(scales), port_filter(filt), k)
    for gi in range(g):
        assert_topk_parity(it[gi].numpy(), dt[gi].numpy(),
                           np.asarray(ij[gi]), np.asarray(dj[gi]),
                           dist_tol(q, deqs[gi]))


def _quant_sources(seed, n_segments, d=24, m=3):
    rng = np.random.default_rng(seed)
    out, gid0 = [], 0
    for sid in range(n_segments):
        n = int(rng.integers(150, 500))
        x = rng.normal(size=(n, d)).astype(np.float32)
        s = rng.uniform(size=(n, m))
        g = np.arange(gid0, gid0 + n, dtype=np.int64)
        gid0 += n
        q8 = tq.encode_segment(x)
        out.append(tss.SegmentShardSource(
            sid, x, s, g, float(s[:, m - 1].min()), float(s[:, m - 1].max()),
            codes=q8.codes, scales=q8.scales, xsq=q8.xsq))
    return out


def _lookup_for(sources):
    x_all = np.concatenate([s.x for s in sources])
    g_all = np.concatenate([s.gids for s in sources])
    by_gid = np.zeros((int(g_all.max()) + 1, x_all.shape[1]), np.float32)
    by_gid[g_all] = x_all
    return lambda gids: (by_gid[np.asarray(gids, np.int64)], None,
                         np.ones(len(gids), bool))


def test_two_stage_equals_fp32_path_with_full_overfetch():
    sources = _quant_sources(7, 3)
    lookup = _lookup_for(sources)
    qp = tss.build_bucketed_pack(sources, n_shards=2, quantize="int8",
                                 device="cpu")
    fp = tss.build_shard_pack(sources, n_shards=2, device="cpu")
    q = np.random.default_rng(8).normal(size=(6, 24)).astype(np.float32)
    for filt in (None, tc.IntervalFilter(dim=2, lo=np.float32(0.3))):
        gi, di = tss.pack_search(qp, q, filt, k=10, lookup=lookup,
                                 rerank_multiple=10_000)
        gf, df = tss.pack_search(fp, q, filt, k=10)
        assert np.array_equal(gi, gf)
        assert np.allclose(np.where(np.isfinite(di), di, 0),
                           np.where(np.isfinite(df), df, 0), atol=1e-4)


def test_reranked_tiebreak_is_dist_then_gid():
    """Duplicated vectors in different segments tie exactly after the
    rerank and come back in ascending gid order, whatever the segment
    insertion order — the contract of host_topk."""
    rng = np.random.default_rng(21)
    base = rng.normal(size=(40, 24)).astype(np.float32)
    dup = base[:3].copy()
    results = []
    for perm in [(0, 1, 2), (2, 0, 1)]:
        sources = []
        for sid in perm:
            x = np.concatenate([dup, base[10 + 10 * sid: 20 + 10 * sid]])
            s = rng.uniform(size=(len(x), 3))
            g = np.arange(sid * 1000, sid * 1000 + len(x), dtype=np.int64)
            q8 = tq.encode_segment(x)
            sources.append(tss.SegmentShardSource(
                sid, x, s, g, 0.0, 1.0, codes=q8.codes, scales=q8.scales,
                xsq=q8.xsq))
        pack = tss.build_bucketed_pack(sources, n_shards=2,
                                       quantize="int8", device="cpu")
        results.append(tss.pack_search(pack, dup[:1], None, k=5,
                                       lookup=_lookup_for(sources),
                                       rerank_multiple=100))
    (g0, d0), (g1, d1) = results
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    assert g0[0, :3].tolist() == [0, 1000, 2000]
    assert d0[0, 0] == d0[0, 1] == d0[0, 2]
    hg, hd = tss.host_topk(g0, d0, 5)
    assert np.array_equal(hg, g0) and np.array_equal(hd, d0)


def _managers(quantize, seed=31, n=1600, d=24, port_only=False, **kw):
    x, s = jw.make_dataset(n, d, 3, seed=seed)
    s[:, 2] = np.arange(n) / n
    cfg = dict(time_dim=2, seal_max_points=400, n_shards=2,
               quantize=quantize, **kw)
    tm = ts.SegmentManager(d, 3, ts.StreamConfig(**cfg, index_cfg=T_IDX),
                           device="cpu")
    tm.ingest(x, s)
    jm = None
    if not port_only:
        jm = js.SegmentManager(d, 3, js.StreamConfig(**cfg, index_cfg=J_IDX))
        jm.ingest(x, s)
    return jm, tm, x, s


def test_quantized_incremental_pack_matches_cold_rebuild():
    _, mgr, x, s = _managers("int8", seed=41, port_only=True)
    rng = np.random.default_rng(42)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    mgr.query(q, None, k=8)                   # cold build
    mgr.delete(rng.integers(0, len(x), 150))
    mgr.ingest(x[:300] + 1.0, s[:300] * [1, 1, 0] + [0, 0, 1.5])
    mgr.seal()
    mgr.compact()
    for filt in (None, tc.IntervalFilter(dim=2, lo=np.float32(0.3))):
        gi, di = mgr.query(q, filt, k=12)
        mgr._pack = None                      # force a from-scratch build
        gr, dr = mgr.query(q, filt, k=12)
        assert np.array_equal(di, dr) and np.array_equal(gi, gr)


def test_manager_quantized_recall_parity_and_bytes():
    """Same stream into both packages' quantized managers: the port's
    recall tracks the reference's and clears the reference's 0.95 bar.
    Device bytes follow the port's own layout (no lane padding): per point
    ``4d + 4m + 4`` fp32 against ``d + 4m + 8`` int8 (plus per-row
    scales), 2.55x at d = 24 and 3.92x at d = 768 — the reference's
    padded TPU layout has a larger ratio, which is not the port's."""
    jm, tm, x, s = _managers("int8")
    _, tf, _, _ = _managers(None, port_only=True)
    tf.query(x[:1], None, k=1)            # the first query builds the pack
    rng = np.random.default_rng(32)
    q = (x[rng.integers(0, len(x), 8)]
         + 0.05 * rng.normal(size=(8, 24)).astype(np.float32))
    f = jc.ComposeFilter(jc.BoxFilter(lo=np.zeros(3, np.float32),
                                      hi=np.ones(3, np.float32)),
                         jc.IntervalFilter(dim=2, lo=np.float32(0.1)), "and")
    gt, _ = jw.ground_truth(x, s, q, f, 10, valid=jm.alive)
    r_j = jw.recall(jm.query(q, f, k=10)[0], gt)
    g_t, d_t = tm.query(q, port_filter(f), k=10)
    r_t = jw.recall(g_t, gt)
    assert r_t >= 0.95 and r_t >= r_j - 0.01
    g_j, d_j = jm.query(q, f, k=10)
    assert (g_t == g_j).mean() >= 0.99
    nb_q, nb_f = tm.stats()["pack_nbytes"], tf.stats()["pack_nbytes"]
    d, m = 24, 3
    assert nb_q > 0 and nb_f / nb_q >= 0.98 * (4 * d + 4 * m + 4) / (
        d + 4 * m + 8)
    assert tm.stats()["quantize"] == "int8"
    assert tm.stats()["pack_buckets"] == jm.stats()["pack_buckets"]


def test_config_validation_matches_reference():
    for kw in ({"quantize": "int4", "n_shards": 1},
               {"quantize": "int8"},
               {"quantize": "int8", "n_shards": 1, "incremental_pack": False},
               {"read_path": "nope"}, {"read_path": "graph"},
               {"read_path": "auto", "n_shards": 2,
                "incremental_pack": False}):
        with pytest.raises(ValueError):
            js.SegmentManager(8, 3, js.StreamConfig(**kw))
        with pytest.raises(ValueError):
            ts.SegmentManager(8, 3, ts.StreamConfig(**kw), device="cpu")


def test_live_snapshot_shape_and_alignment():
    _, mgr, x, _ = _managers("int8", n=800, port_only=True)
    seg = mgr.segments[0]
    mgr.delete(seg.gids[::3])
    out = seg.live_snapshot()
    assert len(out) == 4
    xl, sl, gl, quant = out
    assert len(xl) == len(sl) == len(gl) == quant.n == seg.n_live
    keep = np.nonzero(seg.index.valid)[0]
    assert np.array_equal(quant.codes, seg.quant.codes[keep])
    assert np.array_equal(xl, x[gl])
    assert len(seg.live_snapshot(with_graph=True)) == 5
