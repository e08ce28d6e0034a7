"""Port graph read path (kernel B4's twin, the stitched traversal, the
planner) vs the JAX package.

- B4's twin (``beam_step_plain``, which gathers in torch) against the
  reference's ``_score_candidates_jnp`` and ``beam_step_scores`` (Pallas,
  interpret mode) on tiles gathered from the same fp32 and int8 blocks:
  distances within ``1e-5 * (|q|^2 + max |x|^2)``, predicate masks equal.
- ``bucket_graph_topk`` on packs built from the same
  ``SegmentShardSource``s (same vectors, codes, adjacency and entries):
  distances within that tolerance, ids equal wherever distances are more
  than twice the tolerance apart.  The reference traverses with its jnp
  twin (``use_pallas=False``), as on its own CPU runs.
- ``plan_read_paths`` (numpy in both) gives the same decisions from the
  same stats snapshot.
- Managers with ``read_path="auto"`` and ``"graph"``: scan-biased auto is
  bit for bit forced scan inside the port, graph-biased recall clears the
  reference's 0.95 bar, and the port tracks the reference's answers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.quant as jq
import repro.streaming as js
from repro.core import workloads as jw
from repro.distributed import segment_shards as jss
from repro.kernels import graph_topk as jg
from repro.kernels import ops as jops
from repro.streaming import planner as jp
import repro_torch.core as tc
import repro_torch.streaming as ts
from repro_torch.distributed import segment_shards as tss
from repro_torch.kernels import graph_topk as tg
from repro_torch.kernels import ops as tops
from repro_torch.streaming import planner as tp
from test_torch_kernels import assert_topk_parity, dist_tol, port_filter

torch.set_num_threads(1)

J_IDX = jc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)
T_IDX = tc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)

_FILTERS = {
    "none": None,
    "box": jw.make_box_filter(3, 0.5, seed=4),
    "ball": jc.BallFilter(center=np.asarray([0.5, 0.5]), radius=0.35),
    "box_ball": jc.ComposeFilter(
        jc.BallFilter(center=np.asarray([0.5, 0.5]), radius=0.4),
        jc.IntervalFilter(dim=2, lo=np.float32(0.3)), "and"),
    "box_not_ball": jw.make_compose_filter(3, 0.5, seed=4),
}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", list(_FILTERS))
def test_b4_twin_matches_reference(kind, metric, quantized):
    rng = np.random.default_rng(len(kind) + 7 * quantized)
    rows, cap, d, m, b, c = 3, 64, 24, 3, 8, 40
    x = rng.normal(size=(rows, cap, d)).astype(np.float32)
    s = rng.uniform(size=(rows, cap, m)).astype(np.float32)
    s[:, -5:] = tops.PAD_META                       # padding rows fail
    pos = rng.integers(-1, rows * cap, size=(b, c)).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    scales = None
    if quantized:
        codes = np.zeros((rows, cap, d), np.int8)
        scales = np.zeros((rows, d), np.float32)
        for r in range(rows):
            sq = jq.encode_segment(x[r])
            codes[r], scales[r] = sq.codes, sq.scales
            x[r] = jq.dequantize(sq.codes, sq.scales)
        block = codes
    else:
        block = x
    kind_j, params = jops.encode_filter(_FILTERS[kind], m)
    assert kind_j == kind
    safe = np.maximum(pos, 0)
    cx = x.reshape(-1, d)[safe]                    # dequantized on gather
    cm = np.zeros((b, c, 128), np.float32)
    cm[..., :m] = s.reshape(-1, m)[safe]
    d_j, ok_j = jg._score_candidates_jnp(q, cx, cm, params, kind=kind,
                                         metric=metric)
    d_p, ok_p = jg.beam_step_scores(q, cx, cm, params, kind=kind,
                                    metric=metric, interpret=True)
    pt = torch.as_tensor(tops.encode_filter(port_filter(_FILTERS[kind]), m,
                                            mpad=m)[1])
    d_t, ok_t = tg.beam_step_plain(
        torch.as_tensor(q), torch.as_tensor(pos), torch.as_tensor(block),
        torch.as_tensor(s), pt, kind, metric,
        scales=None if scales is None else torch.as_tensor(scales))
    d_t, ok_t = d_t.numpy(), ok_t.numpy()
    valid = pos >= 0
    tol = dist_tol(q, x.reshape(-1, d))
    for dj, okj in ((d_j, ok_j), (d_p, ok_p)):
        dj, okj = np.asarray(dj), np.asarray(okj)
        assert np.all(np.abs(np.where(valid, d_t - dj, 0)) <= tol)
        assert np.array_equal(ok_t[valid], okj[valid])
    assert np.all(np.isinf(d_t[~valid])) and not ok_t[~valid].any()


def _graph_sources(seed, n_segments=3, d=24, m=3, deg=8, quantize=False):
    """Segments with an exact in-segment kNN adjacency and a few entry
    points, as both packages' sources (same arrays)."""
    rng = np.random.default_rng(seed)
    out, gid0 = [], 0
    for sid in range(n_segments):
        n = int(rng.integers(200, 400))
        x = rng.normal(size=(n, d)).astype(np.float32)
        s = rng.uniform(size=(n, m))
        s[:, m - 1] = sid + rng.uniform(size=n)
        g = np.arange(gid0, gid0 + n, dtype=np.int64)
        gid0 += n
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nbrs = np.argsort(d2, axis=1, kind="stable")[:, :deg].astype(np.int32)
        nbrs[rng.uniform(size=nbrs.shape) < 0.1] = -1
        entries = np.sort(rng.choice(n, 6, replace=False)).astype(np.int32)
        extra = {}
        if quantize:
            sq = jq.encode_segment(x)
            extra = dict(codes=sq.codes, scales=sq.scales, xsq=sq.xsq)
        out.append((sid, x, s, g, float(s[:, m - 1].min()),
                    float(s[:, m - 1].max()), extra, nbrs, entries))
    j = [jss.SegmentShardSource(a[0], *a[1:6], nbrs=a[7], entries=a[8],
                                **a[6]) for a in out]
    t = [tss.SegmentShardSource(a[0], *a[1:6], nbrs=a[7], entries=a[8],
                                **a[6]) for a in out]
    return j, t


class _LaneSpy:
    """Wraps the port's ``beam_step_scores`` (the score callback of
    ``_traverse``) and checks every lane it is handed: a live lane (>= 0)
    holds a point (gid >= 0), appears once in its row, and was not
    visited: after the seed scoring every seed is visited, and after each
    hop every lane it was handed."""

    def __init__(self, monkeypatch, gids, seeds):
        self.gids = gids.reshape(-1)
        self.seeds = {int(p) for p in seeds if p >= 0}
        self.visited = None
        self.calls = 0
        real = tg.beam_step_scores

        def spy(q, pos, *args, **kw):
            self.check(pos)
            return real(q, pos, *args, **kw)
        monkeypatch.setattr(tg, "beam_step_scores", spy)

    def check(self, pos):
        live = pos >= 0
        assert bool((self.gids[pos[live].long()] >= 0).all())
        rows = [pos[r][live[r]].tolist() for r in range(pos.shape[0])]
        for r, row in enumerate(rows):
            assert len(set(row)) == len(row)
            assert self.visited is None or not set(row) & self.visited[r]
        if self.visited is None:
            self.visited = [set(self.seeds) for _ in rows]
        for r, row in enumerate(rows):
            self.visited[r] |= set(row)
        self.calls += 1


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("name", ["none", "box", "box_ball"])
def test_bucket_graph_topk_matches_reference(name, quantize, monkeypatch):
    """Also: B4 is handed only the lanes the traversal keeps."""
    jsrc, tsrc = _graph_sources(5, quantize=quantize is not None)
    jpk = jss.build_bucketed_pack(jsrc, n_shards=2, quantize=quantize,
                                  graph_degree=8)
    tpk = tss.build_bucketed_pack(tsrc, n_shards=2, quantize=quantize,
                                  graph_degree=8, device="cpu")
    jv, tv = jpk.view(), tpk.view()
    assert [b.cap for b in jv.buckets] == [b.cap for b in tv.buckets]
    rng = np.random.default_rng(6)
    x_all = np.concatenate([s.x for s in tsrc])
    q = (x_all[rng.integers(0, len(x_all), 8)]
         + 0.1 * rng.normal(size=(8, 24)).astype(np.float32))
    filt = _FILTERS[name]
    for jb, tb in zip(jv.buckets, tv.buckets):
        seeds = tss.bucket_graph_seeds(tb, 0.5, 2.5)
        assert np.array_equal(seeds, jss.bucket_graph_seeds(jb, 0.5, 2.5))
        out_j = jg.bucket_graph_topk(q, jb, seeds, filt, 10, m=3, ef=32,
                                     width=4, max_iters=64,
                                     use_pallas=False)
        with monkeypatch.context() as mp:
            spy = _LaneSpy(mp, tb.block("gids"), seeds)
            out_t = tg.bucket_graph_topk(q, tb, seeds, port_filter(filt),
                                         10, m=3, ef=32, width=4,
                                         max_iters=64)
        g_j, d_j, hops_j = out_j
        g_t, d_t, hops_t = out_t
        assert spy.calls == hops_t + 1
        assert g_t.dtype == np.int64 and d_t.dtype == np.float32
        assert_topk_parity(g_t, d_t, g_j, d_j, dist_tol(q, x_all))
        assert hops_t == hops_j
    assert tg.bucket_graph_topk(q, tv.buckets[0], np.empty(0, np.int64),
                                None, 5, m=3) is None
    assert tg.bucket_graph_topk(
        q, tv.buckets[0], seeds,
        tc.ComposeFilter(tc.BoxFilter(np.zeros(3), np.ones(3)),
                         tc.BoxFilter(np.zeros(3), np.ones(3)), "or"),
        5, m=3) is None


def test_plan_read_paths_same_decisions():
    jsrc, tsrc = _graph_sources(9, n_segments=4)
    jv = jss.build_bucketed_pack(jsrc, n_shards=2, graph_degree=8).view()
    tv = tss.build_bucketed_pack(tsrc, n_shards=2, graph_degree=8,
                                 device="cpu").view()
    caps = [b.cap for b in tv.buckets]
    def snap(sel):
        row = {k: 1 for k in jp.REQUIRED_STATS_KEYS}
        row.update(selectivity=sel, pruning_rate=0.0)
        return {str(c): dict(row) for c in caps}
    snaps = [{}, snap(0.5), snap(0.01), snap(None)]
    costs = [(jp.PlannerCosts(), tp.PlannerCosts()),
             (jp.PlannerCosts(min_graph_rows=0), tp.PlannerCosts(
                 min_graph_rows=0)),
             (jp.PlannerCosts(hop_cost=0.1), tp.PlannerCosts(hop_cost=0.1))]
    assert dataclasses.asdict(jp.PlannerCosts()) == \
        dataclasses.asdict(tp.PlannerCosts())
    n = 0
    for rp in ("auto", "scan", "graph"):
        for sn in snaps:
            for cj, ct in costs:
                for lo, hi in ((-np.inf, np.inf), (0.5, 1.5), (9.0, 10.0)):
                    for allowed in (True, False):
                        pj = jp.plan_read_paths(jv, rp, sn, cj, lo, hi,
                                                graph_allowed=allowed)
                        pt = tp.plan_read_paths(tv, rp, sn, ct, lo, hi,
                                                graph_allowed=allowed)
                        assert {c: dataclasses.astuple(v)
                                for c, v in pj.items()} == \
                            {c: dataclasses.astuple(v)
                             for c, v in pt.items()}
                        n += len(pt)
    assert n > 0


SCAN_BIASED = dict(hop_cost=1e12)
GRAPH_BIASED = dict(hop_cost=0.0, seed_cost=0.0, base_hops=0.0,
                    hops_per_log2=0.0, min_graph_rows=0, min_selectivity=0.0)


@pytest.mark.parametrize("seed,n_shards,quantize", [(11, 1, None),
                                                    (22, 3, None),
                                                    (33, 2, "int8")])
def test_manager_graph_read_path_parity_and_recall(seed, n_shards,
                                                   quantize):
    """The reference's planner property on the port, beside the
    reference: scan-biased auto equals forced scan bit for bit; graph-
    biased auto and forced graph keep recall@10 >= 0.95 and track the
    reference's answers; both make the same per-bucket decisions and
    traverse with the same hop counts."""
    rng = np.random.default_rng(seed)
    n, d = 1500, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.uniform(size=(n, 3))
    s[:, 2] = np.arange(n) / 500.0
    cfg = dict(time_dim=2, seal_max_points=250, n_shards=n_shards,
               compact_max_segments=3, ttl=2.5, read_path="auto",
               quantize=quantize, graph_ef=128, pack_warm_compile=False)
    jm = js.SegmentManager(d, 3, js.StreamConfig(**cfg, index_cfg=J_IDX))
    tm = ts.SegmentManager(d, 3, ts.StreamConfig(**cfg, index_cfg=T_IDX),
                           device="cpu")
    for m in (jm, tm):
        for lo in range(0, n, 300):
            m.ingest(x[lo:lo + 300], s[lo:lo + 300])
        m.delete(np.arange(0, n, 17))
        m.expire()
        m.compact()
        m.seal()
    q = (x[rng.integers(0, n, 6)]
         + 0.05 * rng.normal(size=(6, d)).astype(np.float32))
    x_all, s_all, present = tm.get_points(np.arange(tm.n_total))
    valid = tm.alive & present
    for filt in (None, jc.IntervalFilter(dim=2, lo=np.float32(1.0))):
        f = port_filter(filt)
        base_j, base_t = jm.cfg, tm.cfg
        jm.cfg = dataclasses.replace(base_j, planner_costs=jp.PlannerCosts(
            **SCAN_BIASED))
        tm.cfg = dataclasses.replace(base_t, planner_costs=tp.PlannerCosts(
            **SCAN_BIASED))
        ga, da = tm.query(q, f, k=10)
        assert all(p.mode == "scan" for p in tm.last_plan.values())
        gs, ds = tm.query(q, f, k=10, read_path="scan")
        assert np.array_equal(ga, gs) and np.array_equal(da, ds)
        jm.cfg = dataclasses.replace(base_j, planner_costs=jp.PlannerCosts(
            **GRAPH_BIASED))
        tm.cfg = dataclasses.replace(base_t, planner_costs=tp.PlannerCosts(
            **GRAPH_BIASED))
        gt, _ = tw_ground_truth(x_all, s_all, q, f, valid)
        for rp in (None, "graph"):
            hops = [m.obs.registry.histogram("graph_hops").snapshot()
                    for m in (tm, jm)]
            g_t, d_t = tm.query(q, f, k=10, read_path=rp)
            g_j, d_j = jm.query(q, filt, k=10, read_path=rp)
            assert {c: p.mode for c, p in tm.last_plan.items()} == \
                {c: p.mode for c, p in jm.last_plan.items()}
            # the same traversals: as many buckets and hops in each
            now = [m.obs.registry.histogram("graph_hops").snapshot()
                   for m in (tm, jm)]
            delta = [(a["count"] - b["count"], a["sum"] - b["sum"])
                     for a, b in zip(now, hops)]
            assert delta[0] == delta[1] and delta[0][0] > 0
            assert any(p.mode == "graph" for p in tm.last_plan.values())
            r_t = jw.recall(g_t, gt)
            assert r_t >= 0.95, (rp, r_t)
            assert r_t >= jw.recall(g_j, gt) - 0.02
            assert (g_t == g_j).mean() >= 0.95
        jm.cfg, tm.cfg = base_j, base_t


def tw_ground_truth(x, s, q, filt, valid):
    from repro_torch.core import workloads as tw
    return tw.ground_truth(x, s, q, filt, 10, valid=valid)
