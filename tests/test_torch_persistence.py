"""Durable snapshots in the port (``repro_torch.streaming.persistence``):
WAL, segment artifacts, manifest and restore, against the JAX package.

Inside the port the invariant is bit for bit: a restored manager answers
every read path (per-segment fan-out, sharded scan, graph, auto; fp32 and
int8) with the gids and distances of the manager it was snapshotted from.
Across packages the on-disk format is shared: the JAX package writes and
the port restores (``device="cpu"``), the port writes and the JAX package
restores, with equal ids wherever distances are unique and distances
within ``tests/test_torch_kernels.py::dist_tol``.  The crash tests raise
from the plain ``fault_hook`` callables at each hook point and restore.
"""
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

import repro.streaming as js
from repro.core import IntervalFilter as JInterval
import repro_torch.streaming as ts
from repro_torch.core import CubeGraphConfig, IntervalFilter
from repro_torch.streaming import persistence as tp
from test_torch_kernels import assert_topk_parity, dist_tol

torch.set_num_threads(1)

D, M, TIME_DIM = 8, 2, 1
IDX = dict(n_layers=2, m_intra=8, m_cross=2)
OPS = ("ingest", "delete", "seal", "compact", "expire", "gc")


def _cfg(pkg, persist_dir=None, n_shards=2, seal=48, ttl=np.inf,
         store_chunk=64, **kw):
    return pkg.StreamConfig(time_dim=TIME_DIM, seal_max_points=seal, ttl=ttl,
                            compact_max_segments=3, n_shards=n_shards,
                            store_chunk=store_chunk, persist_dir=persist_dir,
                            index_cfg=pkg.manager.CubeGraphConfig(**IDX),
                            **kw)


def _port(cfg, **kw):
    return ts.SegmentManager(D, M, cfg, device="cpu", **kw)


def _run(mgr, rng, kinds):
    """One op interleaving (the reference test's coding); ingests use a
    monotone event time."""
    t = getattr(mgr, "_test_t", 0)
    for kind in kinds:
        if kind == "ingest":
            n = int(rng.integers(10, 60))
            x = rng.normal(size=(n, D)).astype(np.float32)
            s = rng.uniform(size=(n, M))
            s[:, TIME_DIM] = (t + np.arange(n)) / 100.0
            t += n
            mgr.ingest(x, s)
        elif kind == "delete" and mgr.n_total:
            mgr.delete(rng.integers(0, mgr.n_total,
                                    size=max(1, mgr.n_total // 6)))
        elif kind == "seal":
            mgr.seal()
        elif kind == "compact":
            mgr.compact()
        elif kind == "expire":
            mgr.expire()
        elif kind == "gc":
            mgr.gc_store()
    mgr._test_t = t


_LIVENESS_KEYS = ("n_total", "n_live", "delta_live", "n_segments",
                  "segment_live", "segment_spans", "now", "sealed",
                  "deleted", "expired_points", "expired_segments",
                  "store_gc_points", "store_resident_points")


def _legs(mgr):
    legs = [dict(use_shards=False), dict(use_shards=True)]
    if mgr.cfg.read_path != "scan":
        legs += [dict(read_path="graph"), dict(read_path="auto")]
    return legs


def _assert_bit_identical(live, restored, seed, b=32, k=5):
    ls, rs = live.stats(), restored.stats()
    for key in _LIVENESS_KEYS:
        assert ls[key] == rs[key], (key, ls[key], rs[key])
    q = np.random.default_rng(seed).normal(size=(b, D)).astype(np.float32)
    t_mid = (live.now / 2.0) if np.isfinite(live.now) else 0.0
    for filt in (None, IntervalFilter(dim=TIME_DIM, lo=np.float32(t_mid))):
        for leg in _legs(live):
            gl, dl = live.query(q, filt, k=k, ef=48, **leg)
            gr, dr = restored.query(q, filt, k=k, ef=48, **leg)
            assert np.array_equal(gl, gr), (leg, filt)
            assert np.array_equal(dl, dr), (leg, filt)


@pytest.mark.parametrize("seed,n_ops,extra", [
    (13, 4, {}), (990, 6, {}), (1967, 8, {"quantize": "int8"}),
    (2944, 5, {"read_path": "auto"}),
    (3921, 7, {"quantize": "int8", "read_path": "graph"})])
def test_restored_equals_original_bit_for_bit(seed, n_ops, extra, tmp_path):
    """Random op interleaving -> snapshot_to -> restore(resume=False):
    liveness stats and every read path's answers are bit for bit."""
    rng = np.random.default_rng(seed)
    mgr = _port(_cfg(ts, ttl=1.5, **extra))
    kinds = ["ingest"] + [OPS[int(rng.integers(0, len(OPS)))]
                          for _ in range(n_ops - 1)]
    _run(mgr, rng, kinds)
    snap = str(tmp_path / "snap")
    man = mgr.snapshot_to(snap)
    assert man["format"] == tp.MANIFEST_FORMAT
    restored = ts.SegmentManager.restore(snap, device="cpu", resume=False)
    assert restored.device == torch.device("cpu")
    _assert_bit_identical(mgr, restored, seed + 1)


def test_incremental_persistence_roundtrip(tmp_path):
    """persist_dir alone (WAL + checkpoints) restores bit for bit, and a
    resumed replica keeps journaling."""
    root = str(tmp_path / "home")
    mgr = _port(_cfg(ts, persist_dir=root, ttl=1.5))
    _run(mgr, np.random.default_rng(7),
         ["ingest", "ingest", "delete", "ingest", "expire", "gc",
          "compact", "ingest", "delete"])
    restored = ts.SegmentManager.restore(root, device="cpu")
    _assert_bit_identical(mgr, restored, 8)
    _run(restored, np.random.default_rng(9), ["ingest", "delete"])
    again = ts.SegmentManager.restore(root, device="cpu", resume=False)
    _assert_bit_identical(restored, again, 10)
    # the checkpointer worker commits the same state again
    restored.checkpoint_async().join(timeout=60)
    assert restored.stats()["health"]["checkpointer"]["runs"] >= 1


def test_wal_torn_tail_replay(tmp_path):
    """Replay stops at the first torn or corrupt frame; a resuming replica
    truncates the tail and keeps journaling from the durable prefix."""
    path = str(tmp_path / "wal.log")
    wal = tp.WriteAheadLog(path, fsync_every=2)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    s = np.ones((3, 2))
    wal.log_ingest(0, x, s)
    wal.log_delete(np.array([1, 2]))
    end = wal.log_gc([0])
    wal.close()
    recs, durable = tp.WriteAheadLog.scan(path)
    assert [r[0] for r in recs] == [tp.REC_INGEST, tp.REC_DELETE, tp.REC_GC]
    assert durable == end == os.path.getsize(path)
    gid0, rx, rs = recs[0][1]
    assert gid0 == 0 and np.array_equal(rx, x) and np.array_equal(rs, s)
    # the frame layout is [u32 len][u32 crc32][type byte + payload]
    with open(path, "rb") as f:
        assert f.read(8) == tp.WAL_MAGIC
        length, crc = struct.unpack("<II", f.read(8))
        assert zlib.crc32(f.read(length)) == crc
    with open(path, "r+b") as f:
        f.truncate(end - 5)                  # tear the last frame
    recs, durable = tp.WriteAheadLog.scan(path)
    assert [r[0] for r in recs] == [tp.REC_INGEST, tp.REC_DELETE]
    assert durable < end - 5
    # and at manager level: a torn ingest loses only that record
    root = str(tmp_path / "home")
    mgr = _port(_cfg(ts, persist_dir=root, seal=10_000))
    _run(mgr, np.random.default_rng(25), ["ingest"])
    n0 = mgr.n_total
    _run(mgr, np.random.default_rng(26), ["ingest"])
    mgr.persist.close()
    wal_path = os.path.join(root, tp.load_manifest(root)["wal_file"])
    size = os.path.getsize(wal_path)
    with open(wal_path, "r+b") as f:
        f.truncate(size - 7)
    restored = ts.SegmentManager.restore(root, device="cpu")
    assert restored.n_total == n0
    assert os.path.getsize(wal_path) < size - 7
    _run(restored, np.random.default_rng(27), ["ingest"])
    again = ts.SegmentManager.restore(root, device="cpu", resume=False)
    assert again.n_total == restored.n_total > n0


class _Crash(RuntimeError):
    """The simulated kill signal raised from a fault hook."""


class _Hook:
    def __init__(self, point):
        self.point = point

    def __call__(self, point):
        if point == self.point:
            raise _Crash(point)


def _ingest_block(mgr, rng, n, t0):
    x = rng.normal(size=(n, D)).astype(np.float32)
    s = rng.uniform(size=(n, M))
    s[:, TIME_DIM] = (t0 + np.arange(n)) / 100.0
    mgr.ingest(x, s)


def _live(mgr):
    return set(np.nonzero(mgr.alive)[0].tolist())


@pytest.mark.parametrize("point", ["wal.append", "wal.fsync",
                                   "segment.write", "manifest.rename"])
def test_crash_at_each_hook_then_restore(point, tmp_path):
    """Kill persistence at each hook point: restore recovers every
    acknowledged point exactly once, no deleted point comes back, and the
    resumed replica keeps journaling losslessly."""
    root = str(tmp_path / "home")
    rng = np.random.default_rng(21)
    mgr = _port(_cfg(ts, persist_dir=root, seal=40, wal_fsync_every=1))
    _ingest_block(mgr, rng, 35, 0)         # acked, below the seal
    mgr.delete([1, 3, 5])
    acked = _live(mgr)
    hook = _Hook(point)
    mgr.persist.fault_hook = hook
    mgr.persist.wal.fault_hook = hook
    with pytest.raises(_Crash):
        _ingest_block(mgr, rng, 30, 35)    # crashes in the WAL or at seal
    restored = ts.SegmentManager.restore(root, device="cpu")
    got = _live(restored)
    assert acked <= got and not ({1, 3, 5} & got)
    assert restored.n_total in (35, 65)
    assert sum(restored.stats()["segment_live"]) + restored.delta.n_live \
        == restored.n_live
    q = np.random.default_rng(22).normal(size=(16, D)).astype(np.float32)
    for us in (False, True):
        g, _ = restored.query(q, None, k=10, use_shards=us)
        for row in g:
            real = [int(v) for v in row if v >= 0]
            assert len(real) == len(set(real)) and set(real) <= got
    _ingest_block(restored, np.random.default_rng(23), 50, 70)
    again = ts.SegmentManager.restore(root, device="cpu", resume=False)
    assert _live(again) == _live(restored)


def test_failed_wal_append_leaves_manager_consistent(tmp_path):
    root = str(tmp_path / "home")
    rng = np.random.default_rng(27)
    mgr = _port(_cfg(ts, persist_dir=root, seal=10_000))
    _ingest_block(mgr, rng, 20, 0)
    size = mgr.persist.wal.offset
    mgr.persist.wal.fault_hook = _Hook("wal.append")
    with pytest.raises(_Crash):
        _ingest_block(mgr, rng, 10, 20)
    assert mgr.n_total == 20 and mgr.persist.wal.offset == size
    mgr.persist.wal.fault_hook = None
    _ingest_block(mgr, rng, 10, 20)
    assert ts.SegmentManager.restore(root, device="cpu",
                                     resume=False).n_total == 30


def test_guards(tmp_path):
    """Attach refuses a populated directory; restore refuses a corrupt
    state blob and an override of the on-disk geometry; the manifest is
    strict JSON (``-inf`` / ``inf`` as null)."""
    root = str(tmp_path / "home")
    mgr = _port(_cfg(ts, persist_dir=root))
    with pytest.raises(ValueError):
        _port(_cfg(ts, persist_dir=root))
    man = json.loads(open(os.path.join(root, tp.MANIFEST_NAME)).read(),
                     parse_constant=lambda c: pytest.fail(c))
    assert man["now"] is None and man["cfg"]["ttl"] is None
    _ingest_block(mgr, np.random.default_rng(29), 60, 0)
    with pytest.raises(tp.RestoreError):
        ts.SegmentManager.restore(root, device="cpu", resume=False,
                                  cfg=_cfg(ts, store_chunk=128))
    ok = ts.SegmentManager.restore(root, device="cpu", resume=False,
                                   cfg=_cfg(ts, n_shards=4))
    assert ok.cfg.n_shards == 4 and ok.n_total == 60
    state = os.path.join(root, tp.load_manifest(root)["state_file"])
    blob = bytearray(open(state, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(state, "wb").write(bytes(blob))
    with pytest.raises(tp.RestoreError):
        ts.SegmentManager.restore(root, device="cpu")


def test_restored_point_arrays_are_copies(tmp_path):
    """An mmapped artifact's read-only arrays are copied into tensors,
    never aliased: the restored index's tensors are writable and the
    host planning metadata stays a memmap."""
    mgr = _port(_cfg(ts, seal=30))
    _ingest_block(mgr, np.random.default_rng(3), 30, 0)
    snap = str(tmp_path / "snap")
    mgr.snapshot_to(snap)
    r = ts.SegmentManager.restore(snap, device="cpu", resume=False)
    idx = r.segments[0].index
    assert isinstance(idx.s_np, np.memmap)
    for t in (idx.x, idx.s):
        assert not np.shares_memory(t.numpy(), idx.s_np)
        t.add_(0.0)                         # writable


def _docs(pkg, n=200):
    from repro.core.workloads import make_dataset
    x, s = make_dataset(n, D, M, seed=91)
    s[:, TIME_DIM] = np.arange(n) / n
    rng = np.random.default_rng(92)
    return [pkg.Document(doc_id=i,
                         tokens=rng.integers(2, 99, size=6).astype(np.int32),
                         embedding=x[i], metadata=s[i]) for i in range(n)], x


def test_document_store_warm_start(tmp_path):
    from repro_torch.serving.rag import Document, DocumentStore
    import repro_torch.serving.rag as trag
    docs, x = _docs(trag)
    store = DocumentStore(docs, CubeGraphConfig(**IDX), streaming=True,
                          stream_cfg=_cfg(ts, seal=64), device="cpu")
    store.delete(np.arange(0, 20))
    snap = str(tmp_path / "snap")
    store.snapshot_to(snap)
    replica = DocumentStore.restore(docs, snap, device="cpu", resume=False)
    f = IntervalFilter(dim=TIME_DIM, lo=np.float32(0.3))
    a = store.retrieve(x[:6], f, k=5)
    b = replica.retrieve(x[:6], f, k=5)
    assert [[d.doc_id for d in r] for r in a] == \
        [[d.doc_id for d in r] for r in b]
    with pytest.raises(ValueError):
        DocumentStore.restore(docs[:10], snap, device="cpu", resume=False)
    static = DocumentStore(docs[:50], CubeGraphConfig(**IDX), device="cpu")
    with pytest.raises(ValueError):
        static.snapshot_to(snap)


def _cross_program(mgr):
    _run(mgr, np.random.default_rng(5),
         ["ingest", "ingest", "delete", "ingest", "seal", "expire",
          "ingest", "gc", "compact", "delete", "ingest"])


def _assert_cross(jm, tm, seed=41, k=5):
    js_, ts_ = jm.stats(), tm.stats()
    for key in _LIVENESS_KEYS:
        assert js_[key] == ts_[key], key
    q = np.random.default_rng(seed).normal(size=(16, D)).astype(np.float32)
    t_mid = jm.now / 2.0
    for jf, tf in ((None, None),
                   (JInterval(dim=TIME_DIM, lo=np.float32(t_mid)),
                    IntervalFilter(dim=TIME_DIM, lo=np.float32(t_mid)))):
        for us in (False, True):
            gj, dj = jm.query(q, jf, k=k, ef=48, use_shards=us)
            gt, dt = tm.query(q, tf, k=k, ef=48, use_shards=us)
            x = jm.get_points(np.arange(jm.n_total))[0]
            assert_topk_parity(gt, dt, gj, dj, dist_tol(q, x))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cross_restore_jax_writes_port_restores(quantize, tmp_path):
    root = str(tmp_path / "home")
    jm = js.SegmentManager(D, M, _cfg(js, persist_dir=root, ttl=1.5,
                                      quantize=quantize))
    _cross_program(jm)
    tm = ts.SegmentManager.restore(root, device="cpu", resume=False)
    assert tm.cfg == ts.persistence._decode_cfg(
        tp.load_manifest(root)["cfg"], None)
    for sj, st in zip(jm.segments, tm.segments):
        assert sj.seg_id == st.seg_id
        np.testing.assert_array_equal(sj.gids, st.gids)
        if quantize:                         # codec payload attached as is
            np.testing.assert_array_equal(sj.quant.codes, st.quant.codes)
            np.testing.assert_array_equal(sj.quant.scales, st.quant.scales)
    _assert_cross(jm, tm)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cross_restore_port_writes_jax_restores(quantize, tmp_path):
    root = str(tmp_path / "home")
    tm = _port(_cfg(ts, persist_dir=root, ttl=1.5, quantize=quantize))
    _cross_program(tm)
    jm = js.SegmentManager.restore(root, resume=False)
    _assert_cross(jm, tm)
    # both packages write the same manifest fields, state keys and
    # artifact files
    jroot = str(tmp_path / "jax")
    jm.snapshot_to(jroot)
    troot = str(tmp_path / "port")
    tm.snapshot_to(troot)
    jman, tman = tp.load_manifest(jroot), tp.load_manifest(troot)
    assert sorted(jman) == sorted(tman)
    # the writer's own persist_dir is the one field that differs
    assert dict(jman["cfg"], persist_dir=None) == \
        dict(tman["cfg"], persist_dir=None)
    assert [sorted(e) for e in jman["segments"]] == \
        [sorted(e) for e in tman["segments"]]
    with np.load(os.path.join(jroot, jman["state_file"])) as zj, \
            np.load(os.path.join(troot, tman["state_file"])) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert zj[key].dtype == zt[key].dtype, key
    ej, et = jman["segments"][0]["dir"], tman["segments"][0]["dir"]
    assert sorted(os.listdir(os.path.join(jroot, ej))) == \
        sorted(os.listdir(os.path.join(troot, et)))
    shutil.rmtree(jroot)
    shutil.rmtree(troot)
