"""Port CubeGraph index (``repro_torch.core``) vs the JAX package.

Both packages build from the same numpy data; the port runs with
``device="cpu"``.  Build parity: cube tables are equal, edges are equal
row for row except where the neighbour lists differ only by fp32 ties.
Search parity runs both packages' query on ONE graph — the reference's,
written by ``repro.core.save_index`` and read by
``repro_torch.core.load_index``.  Recall is held against the reference's
on the workloads of ``tests/test_search.py``.

Distance tolerance: ``1e-5 * (|q|^2 + max |x|^2)`` per query (fp32 sums in
another order, see ``test_torch_kernels.py``).
"""
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import workloads as jw
import repro_torch.core as tc
from repro_torch.core import workloads as tw
from test_torch_kernels import dist_tol, port_filter

torch.set_num_threads(1)

CFG = dict(n_layers=4, m_intra=12, m_cross=4)


@pytest.fixture(scope="module")
def built():
    """tests/test_search.py's workload, built by both packages."""
    x, s = jw.make_dataset(3000, 32, 2, seed=1)
    rng = np.random.default_rng(2)
    q = x[rng.integers(0, 3000, 24)] + 0.05 * rng.normal(
        size=(24, 32)).astype(np.float32)
    ref = jc.CubeGraphIndex.build(x, s, jc.CubeGraphConfig(**CFG))
    port = tc.CubeGraphIndex.build(x, s, tc.CubeGraphConfig(**CFG),
                                   device="cpu")
    return x, s, q, ref, port


@pytest.fixture(scope="module")
def carried(built, tmp_path_factory):
    """The reference's index, read by the port (the state carrier)."""
    x, s, q, ref, _ = built
    d = str(tmp_path_factory.mktemp("ref_index"))
    jc.save_index(ref, d)
    return tc.load_index(d, device="cpu")


def _sq(x, i, ids):
    ok = ids >= 0
    dd = ((x[ids[ok]].astype(np.float64) - x[i].astype(np.float64)) ** 2
          ).sum(-1)
    return np.sort(dd)


def test_build_parity(built):
    x, s, q, ref, port = built
    assert port.n_built_layers == ref.n_built_layers
    np.testing.assert_array_equal(port.grid.lo, ref.grid.lo)
    np.testing.assert_array_equal(port.grid.hi, ref.grid.hi)
    scale = 2e-5 * (x.astype(np.float64) ** 2).sum(1).max()
    for lr, lp in zip(ref.layers, port.layers):
        assert lr.level == lp.level
        np.testing.assert_array_equal(lp.cube_of, lr.cube_of)
        for f in ("uniq", "members", "counts", "entry"):
            np.testing.assert_array_equal(getattr(lp.cubes, f),
                                          getattr(lr.cubes, f))
        for name in ("nbrs", "xnbrs"):
            a = np.asarray(getattr(lr, name))
            b = getattr(lp, name).numpy()
            assert a.shape == b.shape
            diff = np.nonzero((a != b).any(1))[0]
            assert len(diff) <= 0.01 * len(a), (name, len(diff))
            for i in diff:
                if name == "xnbrs":     # exact top-m_cross per direction:
                    # a differing row may only swap fp32-tied neighbours
                    da, db = _sq(x, i, a[i]), _sq(x, i, b[i])
                    assert len(da) == len(db)
                    assert np.all(np.abs(da - db) <= scale)
                # occlusion pruning can cascade a tie flip, but every kept
                # edge stays inside its cube
                ok = b[i] >= 0
                same = lp.cube_of[b[i][ok]] == lp.cube_of[i]
                assert same.all() if name == "nbrs" else not same.any()


@pytest.mark.parametrize("kind,mode", [
    ("box", "predetermined"), ("ball", "onthefly"), ("compose", "onthefly"),
    ("polygon", "onthefly")])
def test_search_parity_on_one_graph(built, carried, kind, mode):
    x, s, q, ref, _ = built
    mk = {"box": jw.make_box_filter, "ball": jw.make_ball_filter,
          "compose": jw.make_compose_filter,
          "polygon": jw.make_polygon_filter}[kind]
    f = mk(2, 0.08, seed=9)
    ids_j, d_j = ref.query(q, f, k=10, ef=96, mode=mode)
    ids_t, d_t = carried.query(q, port_filter(f), k=10, ef=96, mode=mode)
    assert ids_t.dtype == np.int32 and d_t.dtype == np.float32
    same = ids_t == ids_j
    assert same.mean() >= 0.99, same.mean()
    fin = np.isfinite(d_j) & same
    assert np.all(np.abs(np.where(fin, d_t, 0) - np.where(fin, d_j, 0))
                  <= dist_tol(q, x))


@pytest.mark.parametrize("ratio", [0.02, 0.05, 0.15])
def test_predetermined_recall_vs_reference(built, ratio):
    x, s, q, ref, port = built
    f = jw.make_box_filter(2, ratio, seed=int(ratio * 100))
    gt, _ = jw.ground_truth(x, s, q, f, 10)
    r_j = jw.recall(ref.query(q, f, k=10, ef=96, mode="predetermined")[0],
                    gt)
    r_t = tw.recall(port.query(q, port_filter(f), k=10, ef=96,
                               mode="predetermined")[0], gt)
    assert r_t >= r_j - 0.01 and r_t >= 0.9


@pytest.mark.parametrize("kind", ["ball", "polygon", "compose"])
def test_onthefly_recall_vs_reference(built, kind):
    x, s, q, ref, port = built
    mk = {"ball": jw.make_ball_filter, "polygon": jw.make_polygon_filter,
          "compose": jw.make_compose_filter}[kind]
    f = mk(2, 0.08, seed=9)
    gt, _ = jw.ground_truth(x, s, q, f, 10)
    r_j = jw.recall(ref.query(q, f, k=10, ef=96, mode="onthefly")[0], gt)
    r_t = tw.recall(port.query(q, port_filter(f), k=10, ef=96,
                               mode="onthefly")[0], gt)
    assert r_t >= r_j - 0.01 and r_t >= 0.85


def test_query_stats_and_filter(built):
    x, s, q, _, port = built
    f = tw.make_ball_filter(2, 0.1, seed=3)
    ids, d, st = port.query(q, f, k=10, ef=64, return_stats=True)
    assert st.mode == "onthefly" and st.hops >= 1
    got = ids[ids >= 0]
    assert f.contains(torch.as_tensor(s[got])).all()
    finite = np.where(np.isfinite(d), d, 1e30)
    assert np.all(np.diff(finite, axis=1) >= -1e-5)
    empty = tc.BoxFilter(lo=np.asarray([2.0, 2.0]), hi=np.asarray([3.0, 3.0]))
    ids, _ = port.query(q[:4], empty, k=5, ef=32)
    assert np.all(ids == -1)


def test_tie_key_invariant_to_build_order():
    """Duplicated vectors tie exactly; with ``tie_gids`` the port emits the
    same (gid, dist) rows whatever the build order and routing mode, with
    each duplicate pair in ascending gid order (the reference's
    tests/test_planner.py invariant)."""
    rng = np.random.default_rng(33)
    base = rng.normal(size=(50, 16)).astype(np.float32)
    x = np.concatenate([base, base[:5]])
    s = rng.uniform(size=(55, 3))
    s[50:] = s[:5]
    gids = np.arange(55, dtype=np.int64)
    perm = rng.permutation(55)
    cfg = tc.CubeGraphConfig(n_layers=2, m_intra=8, m_cross=3)
    idx_a = tc.CubeGraphIndex.build(x, s, cfg, device="cpu")
    idx_b = tc.CubeGraphIndex.build(x[perm], s[perm], cfg, device="cpu")
    q = base[:3] + np.float32(1e-4)
    filt = tc.BoxFilter(lo=np.full(3, -1.0, np.float32),
                        hi=np.full(3, 2.0, np.float32))
    outs = []
    for mode in ("predetermined", "onthefly"):
        ia, da = idx_a.query(q, filt, k=12, ef=64, mode=mode, tie_gids=gids)
        ib, db = idx_b.query(q, filt, k=12, ef=64, mode=mode,
                             tie_gids=perm.astype(np.int64))
        outs.append((np.where(ia >= 0, gids[np.maximum(ia, 0)], -1), da))
        outs.append((np.where(ib >= 0, perm[np.maximum(ib, 0)], -1), db))
    g0, d0 = outs[0]
    for g, d in outs[1:]:
        assert np.array_equal(g0, g)
        assert np.allclose(d0, d, atol=1e-5)
    for row in g0:
        pos = {int(g): i for i, g in enumerate(row) if g >= 0}
        for lo in range(5):
            if lo in pos and lo + 50 in pos:
                assert pos[lo] < pos[lo + 50]


@pytest.fixture(scope="module")
def upd():
    x, s = tw.make_dataset(2000, 24, 2, seed=1)
    rng = np.random.default_rng(2)
    q = x[rng.integers(0, 2000, 16)] + 0.05 * rng.normal(
        size=(16, 24)).astype(np.float32)
    return x, s, q, tw.make_box_filter(2, 0.08, seed=3)


UPD = tc.CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3)


def test_insert_delete_compact_roundtrip(upd):
    """tests/test_updates.py's update path in the port: build -> insert ->
    delete -> compact keeps filtered recall; inserted points are found and
    deleted ones never returned."""
    x, s, q, f = upd
    idx = tc.CubeGraphIndex.build(x[:1200], s[:1200], UPD, device="cpu")
    idx.insert_batch(x[1200:], s[1200:])
    assert idx.n == 2000
    gt, _ = tw.ground_truth(x, s, q, f, 10)
    ids, _ = idx.query(q, f, k=10, ef=96)
    assert tw.recall(ids, gt) >= 0.8
    gt_new = set(int(v) for row in gt for v in row if v >= 1200)
    if gt_new:
        assert set(int(v) for row in ids for v in row if v >= 1200) & gt_new
    dead = np.random.default_rng(8).choice(2000, size=600, replace=False)
    idx.delete(dead)
    assert abs(idx.deleted_fraction() - 0.3) < 0.01
    ids, _ = idx.query(q, f, k=10, ef=96)
    assert not (set(ids[ids >= 0].tolist()) & set(dead.tolist()))
    compacted = idx.compact()
    keep = np.setdiff1d(np.arange(2000), dead)
    assert compacted.n == len(keep) and compacted.deleted_fraction() == 0.0
    gt_c, _ = tw.ground_truth(x[keep], s[keep], q, f, 10)
    assert tw.recall(compacted.query(q, f, k=10, ef=96)[0], gt_c) >= 0.8


def test_insert_matches_reference_recall(upd):
    x, s, q, f = upd
    x, s = x[:1000], s[:1000]
    jf_ = jw.make_box_filter(2, 0.08, seed=3)
    gt, _ = jw.ground_truth(x, s, q, jf_, 10)
    ref = jc.CubeGraphIndex.build(x[:800], s[:800], jc.CubeGraphConfig(
        n_layers=3, m_intra=10, m_cross=3))
    ref.insert_batch(x[800:], s[800:])
    port = tc.CubeGraphIndex.build(x[:800], s[:800], UPD, device="cpu")
    port.insert_batch(x[800:], s[800:])
    r_j = jw.recall(ref.query(q, jf_, k=10, ef=96)[0], gt)
    r_t = tw.recall(port.query(q, f, k=10, ef=96)[0], gt)
    assert r_t >= r_j - 0.01


def test_save_load_roundtrip_both_ways(tmp_path, upd):
    """The port's artifacts load in both packages and answer like the
    index that wrote them."""
    x, s, q, f = upd
    idx = tc.CubeGraphIndex.build(x[:800], s[:800], UPD, device="cpu")
    ids_a, d_a = idx.query(q, f, k=10, ef=64)
    tc.save_index(idx, str(tmp_path / "idx"), extra_arrays={"g": np.arange(3)},
                  extra_meta={"seg": 7})
    idx2 = tc.load_index(str(tmp_path / "idx"), device="cpu")
    ids_b, d_b = idx2.query(q, f, k=10, ef=64)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)
    arrays, meta = tc.load_index_extras(str(tmp_path / "idx"), ["g"])
    assert meta == {"seg": 7} and np.array_equal(arrays["g"], np.arange(3))
    ref = jc.load_index(str(tmp_path / "idx"))
    ids_j, _ = ref.query(q, jw.make_box_filter(2, 0.08, seed=3), k=10, ef=64)
    assert (ids_j == ids_a).mean() >= 0.99
