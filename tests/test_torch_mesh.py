"""The port's multi-card shard mesh (``repro_torch.distributed.ShardMesh``)
on the CPU.

``ShardMesh(("cpu",) * 4)`` deals bucket rows out to four entries exactly
as four cards would (row ``r`` on entry ``r % 4``, local row ``r // 4``),
so the placement, the per-card copy-on-write, the merge in global row
order and the traversal's per-hop split all run here through the kernels'
plain twins.  Claims:

* bucket geometry and ``bucket_stats()`` equal the reference's on four
  XLA host devices (a subprocess: the test worker's jax has one);
* every answer on the mesh equals the single-device answer bit for bit,
  in ids and distances: both pack layouts and every filter kind through
  deletes, adds, removals and slot doubling; the manager in fp32 and
  int8 on the scan, graph and auto read paths; a grouped flush; a device
  budget that keeps buckets cold; a restore in either direction; and the
  serving stores built on a mesh;
* against the reference (one device) on the same sources or tape, each
  of those mesh answers agrees in ids where distances are unique,
  distances within ``dist_tol`` — so the parity does not rest on the
  single-device port alone.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.serving.rag as jrag
import repro.streaming as js
from repro.core import BoxFilter as JBox
from repro.core import IntervalFilter as JInterval
from repro.distributed import segment_shards as jss
from repro.serving.tenancy import MultiTenantStore as JMultiTenantStore
from repro.streaming.tiering import TierState as JTier
import repro_torch.core as tc
import repro_torch.streaming as ts
from repro_torch.distributed import ShardMesh, make_shard_mesh
from repro_torch.distributed import segment_shards as tss
from repro_torch.serving.rag import Document, DocumentStore
from repro_torch.serving.tenancy import MultiTenantStore
from repro_torch.streaming.persistence import restore_manager
from repro_torch.streaming.query import GroupQuery
from repro_torch.streaming.tiering import TierState
from test_torch_kernels import assert_topk_parity, dist_tol, port_filter
from test_torch_sharded import filters

torch.set_num_threads(1)

MESH = ShardMesh(("cpu",) * 4)
D, M = 16, 3
J_IDX = js.manager.CubeGraphConfig(n_layers=2, m_intra=8, m_cross=3)
T_IDX = tc.CubeGraphConfig(n_layers=2, m_intra=8, m_cross=3)


def same(a, b):
    """Two ``(gids, dists)`` answers (or lists of them) equal bit for
    bit."""
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# Geometry: the reference's on four XLA host devices
# ---------------------------------------------------------------------------
def geometry_tape(ss, n_shards, **kw):
    """``bucket_stats()`` after a build, two removals and six adds (which
    double slots) — run by both packages on the same sources."""
    rng = np.random.default_rng(41 + n_shards)

    def src(sid):
        n = int(rng.integers(250, 500))             # one or two buckets
        x = rng.normal(size=(n, 8)).astype(np.float32)
        s = rng.uniform(size=(n, 3))
        g = np.arange(sid * 2000, sid * 2000 + n, dtype=np.int64)
        return ss.SegmentShardSource(sid, x, s, g, float(sid), sid + 0.5)
    srcs = [src(i) for i in range(10)]
    pack = ss.build_bucketed_pack(srcs[:4], n_shards, **kw)
    tape = [pack.bucket_stats()]
    for sid in (1, 2):
        pack.remove_segment(sid)
    tape.append(pack.bucket_stats())
    for s in srcs[4:]:
        pack.add_segment(s)
    tape.append(pack.bucket_stats())
    return [{str(c): v for c, v in st.items()} for st in tape]


GEOMETRY_SHARDS = (1, 2, 3, 4, 6)
REF_SCRIPT = """
import json
import numpy as np
from repro.distributed import segment_shards as jss
{tape}
mesh = jss.make_shard_mesh(4)
assert mesh.devices.size == 4
print(json.dumps({{n: geometry_tape(jss, n, mesh=mesh) for n in {shards}}}))
"""


@pytest.fixture(scope="module")
def reference_geometry():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    script = REF_SCRIPT.format(tape=inspect.getsource(geometry_tape),
                               shards=GEOMETRY_SHARDS)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("n_shards", GEOMETRY_SHARDS)
def test_mesh_geometry_matches_reference(n_shards, reference_geometry):
    tape = geometry_tape(tss, n_shards, mesh=MESH)
    assert tape == reference_geometry[str(n_shards)]
    # every bucket's rows divide the mesh, each card holding its share
    pack = tss.build_bucketed_pack(
        [tss.SegmentShardSource(0, np.ones((700, 8), np.float32),
                                np.zeros((700, 3)), np.arange(700), 0, 1)],
        n_shards, mesh=MESH)
    for b in pack.buckets.values():
        assert b.n_rows % 4 == 0
        assert [p.shape[0] for p in b.blk["x"]] == [b.n_rows // 4] * 4


def test_make_shard_mesh_contract():
    mesh = ShardMesh(("cpu",) * 6)
    assert mesh.size == 6 and mesh.home == torch.device("cpu")
    # the row -> card map: row r on card r % 6 at local row r // 6
    rows = np.arange(20)
    card, local = mesh.owner(rows)
    assert [list(p) for p in mesh.deal(rows)] == \
        [list(rows[card == c]) for c in range(6)]
    assert all((local[card == c] == np.arange((card == c).sum())).all()
               for c in range(6))
    assert np.array_equal(np.concatenate(mesh.deal(rows))[mesh.order(20)],
                          rows)
    with pytest.raises(ValueError):
        ShardMesh(())
    with pytest.raises(ValueError):                  # home must be device
        ts.SegmentManager(D, M, ts.StreamConfig(n_shards=1), device="meta",
                          shard_mesh=MESH)
    with pytest.raises(ValueError):                  # a mesh never idles:
        ts.SegmentManager(D, M, ts.StreamConfig(), shard_mesh=MESH)
    with pytest.raises(ValueError):                  # nothing to shard
        DocumentStore(_docs(20, 1), device="cpu", shard_mesh=MESH)
    if not torch.cuda.is_available():                # no silent fallback
        with pytest.raises(RuntimeError):
            make_shard_mesh()
        with pytest.raises(RuntimeError):
            make_shard_mesh(2)


# ---------------------------------------------------------------------------
# Scan: both layouts, every filter, through mutations
# ---------------------------------------------------------------------------
def timed_sources(seed, n_segments, d=D, lo=120, hi=700, sid0=0, gid0=0):
    """Segments with disjoint gids and staggered time spans (so a window
    leaves some cards of a bucket without an active row)."""
    rng = np.random.default_rng(seed)
    out = []
    for sid in range(sid0, sid0 + n_segments):
        n = int(rng.integers(lo, hi))
        x = rng.normal(size=(n, d)).astype(np.float32)
        s = rng.uniform(size=(n, M))
        g = np.arange(gid0, gid0 + n, dtype=np.int64)
        gid0 += n
        out.append(tss.SegmentShardSource(sid, x, s, g, float(sid),
                                          sid + 0.5))
    return out


WINDOWS = ((-np.inf, np.inf), (1.2, 3.1))


def _blocks(pack, q, filt, k, ss=tss):
    return [ss.pack_search_blocks(pack.view(), q, filt, k, t_lo=lo,
                                  t_hi=hi) for lo, hi in WINDOWS]


def _mono(pack, q, filt, k, ss=tss):
    return [ss.pack_search(pack, q, filt, k, t_lo=lo, t_hi=hi)
            for lo, hi in WINDOWS]


def near_reference(got, want, tol):
    """The port's answers (or lists of them) against the reference's:
    ids equal where distances are unique, distances within ``tol``."""
    if isinstance(got, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            near_reference(a, b, tol)
        return
    assert_topk_parity(got[0], got[1], np.asarray(want[0]),
                       np.asarray(want[1]), tol)


@pytest.mark.parametrize("layout,quantize,n_shards", [
    ("mono", None, 2), ("mono", None, 3), ("bucketed", None, 1),
    ("bucketed", None, 3), ("bucketed", "int8", 2), ("bucketed", "int8", 5)])
def test_mesh_scan_equals_single_device(layout, quantize, n_shards):
    srcs = timed_sources(n_shards, 5)
    jsrcs = [jss.SegmentShardSource(**dataclasses.asdict(s)) for s in srcs]
    q = np.random.default_rng(7).normal(size=(6, D)).astype(np.float32)
    tol = dist_tol(q, np.concatenate([s.x for s in srcs]))
    if layout == "mono":
        one = tss.build_shard_pack(srcs, n_shards, device="cpu")
        many = tss.build_shard_pack(srcs, n_shards, mesh=MESH)
        ref = jss.build_shard_pack(jsrcs, n_shards)
        search = _mono
    else:
        one = tss.build_bucketed_pack(srcs, n_shards, quantize=quantize,
                                      device="cpu")
        many = tss.build_bucketed_pack(srcs, n_shards, quantize=quantize,
                                       mesh=MESH)
        ref = jss.build_bucketed_pack(jsrcs, n_shards, quantize=quantize)
        search = _blocks
    for name, filt in filters(M, n_shards):
        for k in (5, 300):
            got = search(many, q, port_filter(filt), k)
            same(got, search(one, q, port_filter(filt), k))
            # the reference (Pallas interpret mode) on three filter kinds
            if k == 5 and name in ("none", "box", "box_not_ball"):
                near_reference(got, search(ref, q, filt, k, ss=jss), tol)
    gids = np.concatenate([s.gids for s in srcs])
    dead = np.random.default_rng(8).choice(gids, 150, replace=False)
    assert many.mark_dead(dead) == one.mark_dead(dead) == 150
    same(search(many, q, None, 9), search(one, q, None, 9))
    if layout == "mono":
        return
    # copy-on-write: a view captured now keeps the pre-mutation state
    before = tss.pack_search_blocks(many.view(), q, None, 9)
    old_view = many.view()
    more = timed_sources(n_shards + 50, 7, sid0=10, gid0=int(gids.max()) + 1)
    for pack in (one, many):
        assert pack.remove_segment(1) and pack.remove_segment(3)
        for s in more:                              # reuse, then double
            pack.add_segment(s)
    same(tss.pack_search_blocks(old_view, q, None, 9), before)
    assert many.bucket_stats() != {} and all(
        st["rows"] % 4 == 0 for st in many.bucket_stats().values())
    for _, filt in filters(M, n_shards + 1):
        same(search(many, q, port_filter(filt), 9),
             search(one, q, port_filter(filt), 9))


# ---------------------------------------------------------------------------
# The manager on every read path, beside the reference
# ---------------------------------------------------------------------------
def _stream_cfg(pkg, **kw):
    base = dict(time_dim=2, seal_max_points=200, n_shards=3,
                compact_max_segments=3, ttl=2.0, graph_ef=96,
                pack_warm_compile=False)
    base.update(kw)
    return pkg.StreamConfig(index_cfg=J_IDX if pkg is js else T_IDX, **base)


def _tape(mgr, seed, n=1400):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    s = rng.uniform(size=(n, M))
    s[:, 2] = np.arange(n) / 400.0
    for lo in range(0, n, 350):
        mgr.ingest(x[lo:lo + 350], s[lo:lo + 350])
    mgr.delete(np.arange(0, n, 13))
    mgr.expire()
    mgr.compact()
    mgr.seal()
    return x


def _queries(x, seed, b=6):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, len(x), b)]
            + 0.05 * rng.normal(size=(b, x.shape[1])).astype(np.float32))


WINDOW = tc.IntervalFilter(dim=2, lo=np.float32(1.5))


J_WINDOW = JInterval(dim=2, lo=np.float32(1.5))
BOX = (np.float32([0.1, 0.0, -1e9]), np.float32([0.9, 0.8, 1e9]))
FILTER_PAIRS = {"none": (None, None), "window": (WINDOW, J_WINDOW),
                "box": (tc.BoxFilter(*BOX), JBox(*BOX))}


@pytest.fixture(scope="module")
def reference():
    """``reference(quantize, seed, **cfg)``: the reference's manager after
    ``_tape(seed)``, built once per key and shared by the tests (its index
    builds dominate this file's time); each read path is a per-call
    override."""
    cache = {}

    def get(quantize=None, seed=5, **kw):
        key = (quantize, seed, tuple(sorted(kw.items())))
        if key not in cache:
            ref = js.SegmentManager(D, M, _stream_cfg(
                js, quantize=quantize, read_path="auto", **kw))
            _tape(ref, seed)
            cache[key] = ref
        return cache[key]
    return get


@pytest.mark.parametrize("read_path", ["scan", "graph", "auto"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_mesh_manager_equals_single_device(quantize, read_path, reference):
    kw = dict(quantize=quantize, read_path=read_path)
    one = ts.SegmentManager(D, M, _stream_cfg(ts, **kw), device="cpu")
    many = ts.SegmentManager(D, M, _stream_cfg(ts, **kw), shard_mesh=MESH)
    ref = reference(quantize)
    assert many.device == torch.device("cpu")
    for mgr in (one, many):
        x = _tape(mgr, 5)
    q = _queries(x, 6)
    for filt in (None, WINDOW):
        a = many.query(q, filt, k=10)
        same(a, one.query(q, filt, k=10))
        if read_path != "scan":
            assert {c: p.mode for c, p in many.last_plan.items()} == \
                {c: p.mode for c, p in one.last_plan.items()}
        g_j, d_j = ref.query(q, None if filt is None else J_WINDOW, k=10,
                             read_path=read_path)
        assert_topk_parity(a[0], a[1], g_j, d_j, dist_tol(q, x))
    assert len(many._pack.buckets[next(iter(many._pack.buckets))]
               .blk["s"]) == MESH.size


# ---------------------------------------------------------------------------
# Grouped flush and a device budget
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [2, 3])
def test_mesh_grouped_flush_equals_single_device(n_shards, reference):
    """The grouped flush scans exactly, so the reference's scan answers
    on the same tape (its manager has ``n_shards=3``) are each group's."""
    one = ts.SegmentManager(D, M, _stream_cfg(ts, n_shards=n_shards),
                            device="cpu")
    many = ts.SegmentManager(D, M, _stream_cfg(ts, n_shards=n_shards),
                             shard_mesh=MESH)
    for mgr in (one, many):
        x = _tape(mgr, 5)
    ref = reference()
    groups = [(12, 3, "none", 10), (13, 5, "box", 7), (14, 2, "window", 10),
              (15, 4, "box", 12)]
    groups = [(GroupQuery(_queries(x, seed, b), FILTER_PAIRS[f][0], k),
               FILTER_PAIRS[f][1]) for seed, b, f, k in groups]
    got = many.query_grouped([g for g, _ in groups])
    want = one.query_grouped([g for g, _ in groups])
    for a, b, (g, jf) in zip(got, want, groups):
        same((a[0], a[1]), (b[0], b[1]))
        same((a[0], a[1]), many.query(g.queries, g.filt, k=g.k))
        near_reference((a[0], a[1]), ref.query(g.queries, jf, k=g.k,
                                               read_path="scan"),
                       dist_tol(g.queries, x))


@pytest.mark.parametrize("quantize,read_path", [(None, "scan"),
                                                (None, "graph"),
                                                ("int8", "scan"),
                                                ("int8", "auto")])
def test_mesh_budget_equals_all_resident(quantize, read_path, reference):
    """A budget of a third of the pack keeps buckets cold on the mesh; the
    answers stay the all-resident single-device ones and near the
    reference's, and the tier's decisions on the mesh's per-bucket totals
    are the reference's."""
    kw = dict(quantize=quantize, read_path=read_path, seal_max_points=120)
    one = ts.SegmentManager(D, M, _stream_cfg(ts, **kw), device="cpu")
    probe = ts.SegmentManager(D, M, _stream_cfg(ts, **kw), shard_mesh=MESH)
    for mgr in (one, probe):
        x = _tape(mgr, 21)
    q = _queries(x, 22)
    probe.query(q, None, k=10)
    full = probe._pack.nbytes
    # the budget counts every card's bytes: the sum of the parts
    assert full == sum(p.numel() * p.element_size()
                       for b in probe._pack.buckets.values()
                       for t in b.blk.values() for p in t)
    many = ts.SegmentManager(
        D, M, _stream_cfg(ts, device_budget_bytes=full // 3, **kw),
        shard_mesh=MESH)
    _tape(many, 21)
    ref = reference(quantize, 21, seal_max_points=120)
    for filt, jfilt in (FILTER_PAIRS["none"], FILTER_PAIRS["window"]):
        got = many.query(q, filt, k=10)
        same(got, one.query(q, filt, k=10))
        near_reference(got, ref.query(q, jfilt, k=10, read_path=read_path),
                       dist_tol(q, x))
    pack = many._pack
    assert pack.nbytes <= full // 3
    assert not all(b.resident for b in pack.buckets.values())
    meta = many._bucket_meta(pack)
    jt, tt = JTier(full // 3), TierState(full // 3)
    for t in (jt, tt):
        t.note_window(1.0, 3.0)
    assert tt.pick_victims(meta, full // 2) == jt.pick_victims(meta,
                                                               full // 2)
    assert tt.prefetch_targets(meta) == jt.prefetch_targets(meta)
    for cap in list(pack.buckets):                  # admit everything back
        pack.admit_bucket(cap)
    assert all(len(t) == MESH.size and t[0].device.type == "cpu"
               for b in pack.buckets.values() for t in b.blk.values())
    same(many.query(q, None, k=10), one.query(q, None, k=10))


# ---------------------------------------------------------------------------
# Restore both ways, and the serving stores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_mesh_restore_both_ways(direction, tmp_path, reference):
    kw = dict(quantize="int8", read_path="auto")
    src_kw = ({"shard_mesh": MESH} if direction == "mesh_to_one"
              else {"device": "cpu"})
    dst_kw = ({"device": "cpu"} if direction == "mesh_to_one"
              else {"shard_mesh": MESH})
    mgr = ts.SegmentManager(D, M, _stream_cfg(ts, **kw), **src_kw)
    x = _tape(mgr, 5)
    snap = str(tmp_path / "snap")
    mgr.snapshot_to(snap)
    restored = ts.SegmentManager.restore(snap, resume=False, **dst_kw)
    assert (restored.shard_mesh is MESH) == (direction == "one_to_mesh")
    q = _queries(x, 32)
    ref = reference("int8")                 # the same config and tape
    for filt, jfilt in (FILTER_PAIRS["none"], FILTER_PAIRS["window"]):
        for rp in ("scan", "graph", "auto"):
            got = restored.query(q, filt, k=10, read_path=rp)
            same(got, mgr.query(q, filt, k=10, read_path=rp))
            near_reference(got, ref.query(q, jfilt, k=10, read_path=rp),
                           dist_tol(q, x))
    again = restore_manager(snap, resume=False, **dst_kw)
    same(again.query(q, None, k=10), mgr.query(q, None, k=10))


def _docs(n, seed, cls=Document):
    rng = np.random.default_rng(seed)
    return [cls(doc_id=i, tokens=np.arange(3, dtype=np.int32),
                     embedding=rng.standard_normal(D).astype(np.float32),
                     metadata=np.array([rng.uniform(0, 1), rng.uniform(0, 1),
                                        i / 100.0]))
            for i in range(n)]


@pytest.mark.parametrize("store", ["document", "multi_tenant"])
def test_mesh_stores_equal_single_device(store, tmp_path):
    """Each store on the mesh answers as on one device, and near the
    reference's store built from the same documents."""
    docs = _docs(900, 41)
    jdocs = _docs(900, 41, cls=jrag.Document)
    q = np.stack([d.embedding for d in docs[::150]]) + 0.01
    if store == "document":
        stores = [DocumentStore(docs, streaming=True, read_path="auto",
                                stream_cfg=_stream_cfg(ts, seal_max_points=150),
                                **kw)
                  for kw in ({"device": "cpu"}, {"shard_mesh": MESH})]
        stores.append(jrag.DocumentStore(
            jdocs, streaming=True, read_path="auto",
            stream_cfg=_stream_cfg(js, seal_max_points=150)))
        for s in stores:
            s.delete(np.arange(0, 900, 7))

        def answer(s):
            return s.manager.query(q, WINDOW if s is not ref else J_WINDOW,
                                   k=8)
    else:
        stores = [MultiTenantStore(
            D, M, stream_cfg=_stream_cfg(ts, seal_max_points=150), **kw)
            for kw in ({"device": "cpu"}, {"shard_mesh": MESH})]
        stores.append(JMultiTenantStore(
            D, M, stream_cfg=_stream_cfg(js, seal_max_points=150)))
        for s, dd in zip(stores, (docs, docs, jdocs)):
            for tenant, lo in (("a", 0), ("b", 450)):
                s.create_collection(tenant)
                s.insert(tenant, dd[lo:lo + 450])
            s.maintenance()

        def answer(s):
            r = s.retrieve("b", q, WINDOW if s is not ref else J_WINDOW,
                           k=8)
            return r.gids, r.dists
    one, many, ref = stores
    assert many.manager.shard_mesh is MESH
    same(answer(many), answer(one))
    x = np.stack([d.embedding for d in docs])
    near_reference(answer(many), answer(ref), dist_tol(q, x))
    snap = str(tmp_path / "snap")
    many.snapshot_to(snap)
    if store == "document":
        back = DocumentStore.restore(docs, snap, resume=False,
                                     shard_mesh=MESH)
    else:
        back = MultiTenantStore.restore(snap, D, M, resume=False,
                                        shard_mesh=MESH)
    same(answer(back), answer(one))


def test_mesh_pack_state_is_per_card():
    """A delta clones only the owning cards' tensors; evicting and
    admitting keep each card's rows on that card; answers never move."""
    rng = np.random.default_rng(4)
    srcs = [tss.SegmentShardSource(
        sid, rng.normal(size=(300, D)).astype(np.float32),
        rng.uniform(size=(300, M)), np.arange(sid * 300, sid * 300 + 300),
        0.0, 1.0) for sid in range(2)]
    pack = tss.build_bucketed_pack(srcs[:1], 2, mesh=MESH)
    (cap, b), = pack.buckets.items()
    assert b.n_rows == 4 and b.free_slots == [1]    # 4 // gcd(2, 4) slots
    before = dict(b.blk)
    q = rng.normal(size=(3, D)).astype(np.float32)
    view = pack.view()
    first = tss.pack_search_blocks(view, q, None, 8)
    pack.add_segment(srcs[1])                       # slot 1: rows 2, 3
    for name, parts in b.blk.items():
        assert [p is o for p, o in zip(parts, before[name])] == \
            [True, True, False, False], name
    same(tss.pack_search_blocks(view, q, None, 8), first)
    resident = tss.pack_search_blocks(pack.view(), q, None, 8)
    assert pack.evict_bucket(cap) == pack.buckets[cap].full_nbytes > 0
    assert pack.nbytes == 0 and pack.host_nbytes > 0
    same(tss.pack_search_blocks(pack.view(), q, None, 8), resident)
    assert pack.admit_bucket(cap) > 0
    assert [p.shape[0] for p in pack.buckets[cap].blk["gids"]] == [1] * 4
    same(tss.pack_search_blocks(pack.view(), q, None, 8), resident)
