"""Hand-written CUDA kernels vs their plain PyTorch twins, on the card.

Marked ``cuda``; each test asks the ``card`` fixture for the device, which
skips when no CUDA card is present (decided at run time, never at import,
so every pytest-xdist worker collects the same tests).  Run on a machine
with a card::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BallFilter, ComposeFilter, IntervalFilter
from repro_torch.core.workloads import (make_box_filter, make_compose_filter,
                                        make_dataset_device)
from repro_torch.kernels import ops
from repro_torch.kernels.distance import (pairwise_dist_call,
                                          pairwise_dist_plain)
from repro_torch.kernels.filtered_topk import (filtered_topk_call,
                                               filtered_topk_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _data(card, n=3001, d=96, m=3, bq=29):
    x, s = make_dataset_device(n, d, m, seed=n, device=card)
    return x[:bq] + 0.05, x, s


def _tol(q, x):
    """fp32 tolerance on |q|^2 + |x|^2 (the kernel and the twin sum the
    products in different orders)."""
    return 1e-5 * ((q ** 2).sum(1) + (x ** 2).sum(1).max())[:, None]


_FILTERS = {
    "none": None,
    "box": make_box_filter(3, 0.3, seed=1),
    "ball": BallFilter(center=np.asarray([0.5, 0.5]), radius=0.35),
    "box_ball": ComposeFilter(BallFilter(center=np.asarray([0.5, 0.5]),
                                         radius=0.35),
                              IntervalFilter(dim=2, lo=0.1, hi=0.9), "and"),
    "box_not_ball": make_compose_filter(3, 0.3, seed=2),
}


@pytest.mark.parametrize("k", [10, 100, 300])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", list(_FILTERS))
def test_filtered_topk_kernel_matches_twin(card, kind, metric, k):
    q, x, s = _data(card)
    got_kind, params = ops.encode_filter(_FILTERS[kind], 3, mpad=3)
    assert got_kind == kind
    p = torch.as_tensor(params, device=card)[None]
    kpad = ops.next_pow2(max(k, 8))
    kd, ki = filtered_topk_call(q[None], x[None], s[None], p, kind, kpad,
                                metric)
    torch.cuda.synchronize()
    td, ti = filtered_topk_plain(q[None], x[None], s[None], p, kind, kpad,
                                 metric)
    fin = torch.isfinite(td)
    assert torch.equal(torch.isfinite(kd), fin)
    assert torch.equal(ki < 0, ~fin)
    tol = _tol(q, x)[None]
    assert bool((torch.where(fin, (kd - td).abs(), 0) <= tol).all())
    # ids agree where the distance is not an fp32 tie with a neighbour
    gap = td[..., 1:] - td[..., :-1]
    inf = torch.full_like(td[..., :1], float("inf"))
    uniq = fin & (torch.cat([inf, gap], -1) > 2 * tol) \
        & (torch.cat([gap, inf], -1) > 2 * tol)
    uniq[..., -1] = False
    assert torch.equal(ki[uniq], ti[uniq])


def test_filtered_topk_kernel_batch_axis(card):
    q, x, s = _data(card)
    p = torch.as_tensor(ops.encode_filter(_FILTERS["box"], 3, mpad=3)[1],
                        device=card)
    xs = torch.stack([x[:1500], x[1500:3000]])
    ss = torch.stack([s[:1500], s[1500:3000]])
    kd, ki = filtered_topk_call(q[None], xs, ss, p[None], "box", 16)
    for g in range(2):
        d1, i1 = filtered_topk_call(q[None], xs[g:g + 1], ss[g:g + 1],
                                    p[None], "box", 16)
        assert torch.equal(kd[g], d1[0]) and torch.equal(ki[g], i1[0])


def test_filtered_topk_kernel_counts_launches(card):
    import importlib
    b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
    q, x, s = _data(card)
    before = b1.launch_count()
    ops.filtered_topk(q, x, s, None, 10)
    assert b1.launch_count() == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_dist_kernel_matches_twin(card, dtype, metric):
    q, x, _ = _data(card)
    q, x = q.to(dtype), x.to(dtype)
    got = pairwise_dist_call(q, x, metric)
    torch.cuda.synchronize()
    want = pairwise_dist_plain(q, x, metric)
    assert bool(((got - want).abs() <= _tol(q.float(), x.float())).all())
