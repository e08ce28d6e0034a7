"""The paper's baselines in the port (``repro_torch.core.baselines``) vs the
JAX package, on the workload of ``tests/test_baselines.py``.

Both packages build from the same numpy data; the port runs with
``device="cpu"``.  Graphs: the monolithic graph (PostFiltering /
PreFiltering / ACORN) and the TreeGraph's per-leaf graphs equal the
reference's row for row except where fp32 ties flip a neighbour (at most
1% of rows, as ``tests/test_torch_index.py::test_build_parity``); the
KD-tree (leaves, members, entry points) and the subquery counts are equal.
Recall: within 0.02 of the reference's per baseline at the same ef, and
the paper's headline ordering holds in the port.
"""
import numpy as np
import pytest
import torch

from repro.core import CubeGraphConfig as JConfig
from repro.core import CubeGraphIndex as JIndex
from repro.core import baselines as jb
from repro.core.filters import BoxFilter as JBox
from repro.core.workloads import ground_truth, make_box_filter, make_dataset
from repro.core.workloads import recall
import repro_torch.core as tc
from repro_torch.core import baselines as tb
from test_torch_kernels import port_filter

torch.set_num_threads(1)

GAMMA = 4
RECALL_TOL = 0.02


@pytest.fixture(scope="module")
def data():
    x, s = make_dataset(3000, 32, 2, seed=1)
    rng = np.random.default_rng(2)
    q = x[rng.integers(0, 3000, 24)] + 0.05 * rng.normal(
        size=(24, 32)).astype(np.float32)
    f = make_box_filter(2, 0.05, seed=3)
    gt, _ = ground_truth(x, s, q, f, 10)
    f_all = JBox(lo=np.asarray([-1.0, -1.0], np.float32),
                 hi=np.asarray([2.0, 2.0], np.float32))
    gt_all, _ = ground_truth(x, s, q, f_all, 10)
    return x, s, q, f, gt, f_all, gt_all


@pytest.fixture(scope="module")
def built(data):
    """{name: (reference index, port index)}: the monolithic graph is
    shared by PostFiltering and PreFiltering in both packages."""
    x, s = data[:2]
    post_j, post_t = jb.PostFilteringIndex(x, s), \
        tb.PostFilteringIndex(x, s, device="cpu")
    pre_j, pre_t = jb.PreFilteringIndex.__new__(jb.PreFilteringIndex), \
        tb.PreFilteringIndex.__new__(tb.PreFilteringIndex)
    pre_j.__dict__.update(post_j.__dict__)
    pre_t.__dict__.update(post_t.__dict__)
    return {
        "post": (post_j, post_t), "pre": (pre_j, pre_t),
        "acorn": (jb.AcornIndex(x, s, gamma=GAMMA),
                  tb.AcornIndex(x, s, gamma=GAMMA, device="cpu")),
        "tree": (jb.TreeGraphIndex(x, s, leaf_size=256),
                 tb.TreeGraphIndex(x, s, leaf_size=256, device="cpu")),
    }


def _rows_match(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    diff = np.nonzero((a != b).any(1))[0]
    assert len(diff) <= 0.01 * len(a), len(diff)


@pytest.mark.parametrize("name", ["post", "acorn", "tree"])
def test_graph_parity(built, name):
    ref, port = built[name]
    if name == "tree":
        assert port.n_leaves == ref.n_leaves
        np.testing.assert_array_equal(port.leaf_of, ref.leaf_of)
        for f in ("uniq", "members", "counts", "entry"):
            np.testing.assert_array_equal(getattr(port.cubes, f),
                                          getattr(ref.cubes, f))
        _rows_match(ref.nbrs, port.nbrs.numpy())
        # per-leaf graphs: every kept edge stays inside its leaf
        nb = port.nbrs.numpy()
        ok = nb >= 0
        rows = np.nonzero(ok)[0]
        assert (port.leaf_of[nb[ok]] == port.leaf_of[rows]).all()
    else:
        np.testing.assert_array_equal(port.graph.cubes.entry,
                                      ref.graph.cubes.entry)
        _rows_match(ref.graph.nbrs, port.graph.nbrs.numpy())
        assert port.graph.xnbrs.shape == tuple(ref.graph.xnbrs.shape)
    assert port.index_bytes() == ref.index_bytes()


@pytest.mark.parametrize("name,ef", [("post", 64), ("post", 1024),
                                     ("pre", 64), ("acorn", 64),
                                     ("tree", 64)])
def test_recall_matches_reference(data, built, name, ef):
    x, s, q, f, gt = data[:5]
    ref, port = built[name]
    tf = port_filter(f)
    if name == "tree":
        ids_j, _, n_j = ref.query(q, f, k=10, ef=ef,
                                  return_n_subqueries=True)
        ids_t, d_t, n_t = port.query(q, tf, k=10, ef=ef,
                                     return_n_subqueries=True)
        assert n_t == n_j >= 2
    else:
        ids_j, _ = ref.query(q, f, k=10, ef=ef)
        ids_t, d_t = port.query(q, tf, k=10, ef=ef)
    assert ids_t.shape == (24, 10) and d_t.shape == (24, 10)
    r_j, r_t = recall(ids_j, gt), recall(ids_t, gt)
    assert abs(r_t - r_j) <= RECALL_TOL, (r_t, r_j)
    # every returned point passes the filter
    ok = ids_t >= 0
    assert np.asarray(f.contains(s[ids_t[ok]])).all()


def test_postfilter_pure_ann_navigable(data, built):
    """The port's monolithic graph is navigable (recall >= 0.95
    unfiltered), as the reference's."""
    x, s, q, f, gt, f_all, gt_all = data
    ref, port = built["post"]
    ids_t, _ = port.query(q, port_filter(f_all), k=10, ef=64)
    ids_j, _ = ref.query(q, f_all, k=10, ef=64)
    assert recall(ids_t, gt_all) >= 0.95
    assert abs(recall(ids_t, gt_all) - recall(ids_j, gt_all)) <= RECALL_TOL


def test_headline_ordering_in_port(data, built):
    """The paper's headline inside the port: CubeGraph beats PostFiltering
    and PreFiltering at the same ef, ACORN beats PreFiltering, and
    PostFiltering recovers with a large ef."""
    x, s, q, f, gt = data[:5]
    tf = port_filter(f)
    cg = tc.CubeGraphIndex.build(x, s, tc.CubeGraphConfig(
        n_layers=4, m_intra=12, m_cross=4), device="cpu")
    r = {"cg": recall(cg.query(q, tf, k=10, ef=64)[0], gt)}
    for name in ("post", "pre", "acorn"):
        r[name] = recall(built[name][1].query(q, tf, k=10, ef=64)[0], gt)
    r["post_1024"] = recall(built["post"][1].query(q, tf, k=10,
                                                   ef=1024)[0], gt)
    assert r["cg"] >= 0.9 and r["cg"] > r["post"] and r["cg"] > r["pre"]
    assert r["acorn"] > r["pre"]
    assert r["post"] < 0.8 <= 0.9 <= r["post_1024"]
    # the same ordering the reference shows on its own graphs
    jcg = JIndex.build(x, s, JConfig(n_layers=4, m_intra=12, m_cross=4))
    assert recall(jcg.query(q, f, k=10, ef=64)[0], gt) >= 0.9


def test_baselines_default_to_the_card(data):
    """Like CubeGraphIndex.build, a baseline without device= asks for the
    card and raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, s = data[:2]
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.TreeGraphIndex(x[:100], s[:100])
