"""Port kernels and ops (``repro_torch.kernels``) vs the JAX package.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernels in
interpret mode, or the package's plain jnp path where the interpret-mode
kernel would unroll hundreds of argmin rounds) and through
``repro_torch.kernels`` with ``device="cpu"``, i.e. the hand-written
kernels' plain PyTorch twins.

Tolerances: fp32 distances are compared with an absolute tolerance of
``1e-5 * (|q|^2 + max |x|^2)`` per query row — the two frameworks sum the
d products in different orders, and the L2 form ``|q|^2 - 2 q.x + |x|^2``
cancels terms of that magnitude.  Ids must be equal wherever the
reference's distances are separated from their list neighbours by more
than twice that tolerance.
"""
import numpy as np
import pytest
import torch

import repro.core.filters as jf
from repro.core import workloads as jw
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro_torch.core.filters as tf
from repro_torch.core import workloads as tw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.filtered_topk import (filtered_topk_call,
                                               filtered_topk_plain)

torch.set_num_threads(1)


def port_filter(f):
    """A reference filter object -> the port's, with the same numbers."""
    if f is None:
        return None
    if isinstance(f, jf.BoxFilter):
        return tf.BoxFilter(np.asarray(f.lo), np.asarray(f.hi))
    if isinstance(f, jf.IntervalFilter):
        return tf.IntervalFilter(f.dim, None if f.lo is None else
                                 np.asarray(f.lo),
                                 None if f.hi is None else np.asarray(f.hi))
    if isinstance(f, jf.BallFilter):
        return tf.BallFilter(np.asarray(f.center), np.asarray(f.radius))
    if isinstance(f, jf.PolygonFilter):
        return tf.PolygonFilter(np.asarray(f.vertices), np.asarray(f.rest_lo),
                                np.asarray(f.rest_hi))
    return tf.ComposeFilter(port_filter(f.a), port_filter(f.b), f.op)


def dist_tol(q, x):
    q = np.asarray(q, np.float64)
    x = np.asarray(x, np.float64)
    return 1e-5 * ((q ** 2).sum(1) + (x ** 2).sum(1).max())[:, None]


def assert_topk_parity(ids_t, d_t, ids_j, d_j, tol):
    """Port (ids_t, d_t) vs reference (ids_j, d_j), both [bq, k]."""
    ids_t, d_t = np.asarray(ids_t), np.asarray(d_t, np.float64)
    ids_j, d_j = np.asarray(ids_j), np.asarray(d_j, np.float64)
    fin = np.isfinite(d_j)
    assert np.array_equal(np.isfinite(d_t), fin)
    assert np.array_equal(ids_t < 0, ~fin) and np.array_equal(ids_j < 0, ~fin)
    assert np.all(np.abs(np.where(fin, d_t, 0.0) - np.where(fin, d_j, 0.0))
                  <= tol)
    dj = np.where(fin, d_j, 1e300)
    gap = np.diff(dj, axis=1)
    big = np.full((dj.shape[0], 1), np.inf)
    unique = fin & (np.concatenate([big, gap], 1) > 2 * tol) \
        & (np.concatenate([gap, big], 1) > 2 * tol)
    unique[:, -1] = False          # its next neighbour is outside the list
    assert np.array_equal(ids_t[unique], ids_j[unique])


@pytest.mark.parametrize("bq,n,d", [(4, 64, 16), (16, 300, 48), (33, 513, 130),
                                    (1, 1000, 96), (128, 256, 128)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_dist_matches_reference(bq, n, d, metric):
    rng = np.random.default_rng(bq * 1000 + n + d)
    q = rng.normal(size=(bq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(jops.pairwise_dist(q, x, metric=metric))
    got = tops.pairwise_dist(q, x, metric=metric, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (bq, n)
    assert np.all(np.abs(got.numpy() - want) <= dist_tol(q, x))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_dist_bf16_matches_reference(metric):
    """bf16 inputs, fp32 accumulation: bf16 products are exact in fp32, so
    only the summation order differs (same tolerance as fp32)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    qj = jnp.asarray(rng.normal(size=(8, 64)), jnp.bfloat16)
    xj = jnp.asarray(rng.normal(size=(128, 64)), jnp.bfloat16)
    want = np.asarray(jops.pairwise_dist(qj, xj, metric=metric))
    qt = torch.tensor(np.asarray(qj.astype(jnp.float32))).bfloat16()
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).bfloat16()
    got = tops.pairwise_dist(qt, xt, metric=metric, device="cpu")
    assert np.all(np.abs(got.numpy() - want)
                  <= dist_tol(qt.float().numpy(), xt.float().numpy()))


def _filters(m):
    """Every kernel filter kind, plus two filters without an encoding."""
    ball2 = jf.BallFilter(center=np.asarray([0.5, 0.45], np.float32),
                          radius=np.float32(0.3))
    iv = jf.IntervalFilter(dim=m - 1, lo=np.float32(0.2), hi=np.float32(0.8))
    return {
        "none": None,
        "box": jw.make_box_filter(m, 0.3, seed=m),
        "interval_halfopen": jf.IntervalFilter(dim=m - 1, lo=np.float32(0.4)),
        "ball": ball2,
        "box_ball": jf.ComposeFilter(ball2, iv, "and"),
        "box_not_ball": jw.make_compose_filter(m, 0.3, seed=m),
        "polygon": jw.make_polygon_filter(m, 0.3, seed=m),
        "or": jf.ComposeFilter(jw.make_box_filter(m, 0.1, seed=1), ball2,
                               "or"),
    }


_KIND = {"none": "none", "box": "box", "interval_halfopen": "box",
         "ball": "ball", "box_ball": "box_ball",
         "box_not_ball": "box_not_ball", "polygon": None, "or": None}


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("name", list(_KIND))
def test_encode_filter_bit_equal(m, name):
    f = _filters(m)[name]
    want = jops.encode_filter(f, m)
    got = tops.encode_filter(port_filter(f), m)
    if _KIND[name] is None:
        assert want is None and got is None
        return
    assert got[0] == want[0] == _KIND[name]
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    # the narrow layout the port hands its kernel is the same numbers
    narrow = tops.encode_filter(port_filter(f), m, mpad=max(m, 2))
    assert np.array_equal(narrow[1][:, :m], want[1][:, :m])
    assert np.array_equal(narrow[1][3, :2], want[1][3, :2])


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("name", [k for k in _KIND if k != "none"])
def test_filter_contains_matches_reference(m, name):
    import jax.numpy as jnp
    f = _filters(m)[name]
    rng = np.random.default_rng(m)
    s = rng.uniform(0, 1, size=(3000, m))
    want = np.asarray(f.contains(jnp.asarray(s)))
    got = port_filter(f).contains(torch.as_tensor(s))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    lo_j, hi_j = f.bounding_box()
    lo_t, hi_t = port_filter(f).bounding_box()
    assert np.array_equal(lo_j, lo_t) and np.array_equal(hi_j, hi_t)
    assert f.characteristic_length() == \
        port_filter(f).characteristic_length()


@pytest.mark.parametrize("name", ["box", "ball", "box_ball", "box_not_ball"])
def test_packed_mask_matches_reference(name):
    """The packed-parameter predicate the kernel evaluates agrees with the
    reference oracle, and rows carrying PAD_META fail every kind."""
    import jax.numpy as jnp
    m = 3
    f = _filters(m)[name]
    kind, params = jops.encode_filter(f, m)
    rng = np.random.default_rng(7)
    s = rng.uniform(0, 1, size=(2000, m)).astype(np.float32)
    want = np.asarray(jref.filter_mask_ref(jnp.asarray(s), kind,
                                           jnp.asarray(params)))
    got = tref.filter_mask_ref(torch.as_tensor(s), kind,
                               torch.as_tensor(params))
    assert np.array_equal(got.numpy(), want)
    pad = torch.full((5, m), tref.PAD_META)
    for k in (kind, "none"):
        assert not tref.filter_mask_ref(pad, k,
                                        torch.as_tensor(params)).any()


@pytest.mark.parametrize("k", [5, 10, 50, 300])
@pytest.mark.parametrize("name", [k for k in _KIND if k != "or"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_filtered_topk_matches_reference(metric, name, k):
    """Ragged bq / n.  k = 10 runs the reference's Pallas kernel in
    interpret mode; other k its plain jnp path (same semantics)."""
    m = 3
    x, s = jw.make_dataset(777, 40, m, seed=k)
    rng = np.random.default_rng(k)
    q = x[rng.integers(0, 777, 13)] + 0.05 * rng.normal(size=(13, 40)) \
        .astype(np.float32)
    f = _filters(m)[name]
    ids_j, d_j = jops.filtered_topk(q, x, s, f, k, metric=metric,
                                    use_kernel=k == 10)
    ids_t, d_t = tops.filtered_topk(q, x, s, port_filter(f), k,
                                    metric=metric, device="cpu")
    assert ids_t.dtype == torch.int32 and d_t.dtype == torch.float32
    assert tuple(ids_t.shape) == (13, k)
    assert_topk_parity(ids_t, d_t, ids_j, d_j, dist_tol(q, x))
    got = ids_t.numpy()
    if f is not None and (got >= 0).any():
        import jax.numpy as jnp
        ok = np.asarray(f.contains(jnp.asarray(s[got[got >= 0]])))
        assert ok.all()


def test_filtered_topk_fewer_candidates_than_k():
    """n < k pads with -1 / +inf, like the reference's kernel path."""
    x, s = jw.make_dataset(6, 8, 2, seed=1)
    ids_j, d_j = jops.filtered_topk(x[:2], x, s, None, 10)
    ids_t, d_t = tops.filtered_topk(x[:2], x, s, None, 10, device="cpu")
    assert_topk_parity(ids_t, d_t, ids_j, d_j, dist_tol(x[:2], x))
    assert (ids_t[:, 6:] == -1).all()


def test_exact_filtered_search_matches_ground_truth():
    x, s = tw.make_dataset(1500, 32, 3, seed=4)
    q = x[:9] + 0.01
    f = tw.make_box_filter(3, 0.1, seed=4)
    ids, dd = tops.exact_filtered_search(q, x, s, f, 10, device="cpu")
    gt_i, gt_d = tw.ground_truth(x, s, q, f, 10)
    assert tw.recall(ids.numpy(), gt_i) == 1.0
    assert np.all(np.abs(dd.numpy() - gt_d) <= dist_tol(q, x))


def test_twin_batch_axis_equals_per_set_calls():
    """The kernel's leading batch axis g: shared queries, per-set candidates
    and per-set filter parameters give the per-set answers."""
    x, s = tw.make_dataset(900, 24, 3, seed=2)
    xt, st = torch.as_tensor(x), torch.as_tensor(s).float()
    q = xt[:7] + 0.01
    params = [tops.encode_filter(tw.make_box_filter(3, 0.3, seed=i), 3,
                                 mpad=3)[1] for i in range(3)]
    pt = torch.as_tensor(np.stack(params))
    xs = torch.stack([xt[:300], xt[300:600], xt[600:]])
    ss = torch.stack([st[:300], st[300:600], st[600:]])
    dd, ii = filtered_topk_call(q[None], xs, ss, pt, "box", 16)
    for g in range(3):
        d1, i1 = filtered_topk_plain(q[None], xs[g:g + 1], ss[g:g + 1],
                                     pt[g:g + 1], "box", 16)
        assert torch.equal(dd[g], d1[0]) and torch.equal(ii[g], i1[0])


def test_kernel_helpers_match_reference():
    for v in (0, 1, 2, 3, 8, 9, 300, 1024, 1025):
        assert tops.next_pow2(v) == jops.next_pow2(v)
        for mult in (1, 8, 128, 256):
            assert tops.round_up(v, mult) == jops.round_up(v, mult)
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    for axis, mult in ((0, 4), (1, 8), (0, 5)):
        want = np.asarray(jops._pad_to(a, axis, mult, 2e30))
        got = tops._pad_to(torch.as_tensor(a), axis, mult, 2e30)
        assert np.array_equal(got.numpy(), want)
    assert tops.PAD_META == jops.PAD_META


def test_wrappers_raise_on_bad_inputs():
    x = torch.zeros(10, 4)
    s = torch.zeros(10, 2)
    p = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError):
        filtered_topk_call(x[None, :2], x[None], s[None], p, "box", 12)
    with pytest.raises(ValueError):
        filtered_topk_call(x[None, :2], x[None], s[None], p, "cone", 16)
    with pytest.raises(TypeError):
        filtered_topk_call(x[None, :2].double(), x[None], s[None], p, "box",
                           16)
    with pytest.raises(TypeError):
        tops.pairwise_dist(x.half(), x.half(), device="cpu")


def test_entry_points_refuse_missing_card():
    """Without a card, an entry point called without device='cpu' raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.core import CubeGraphIndex
    from repro_torch.streaming import SegmentManager
    x, s = tw.make_dataset(50, 8, 2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.filtered_topk(x[:2], x, s, None, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.exact_filtered_search(x[:2], x, s, None, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.pairwise_dist(x[:2], x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CubeGraphIndex.build(x, s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmentManager(8, 2)
