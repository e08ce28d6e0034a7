"""The plain reference against a NumPy brute force, on tiny inputs."""
import numpy as np
import pytest
import torch

from portbench import reference


def _brute(x, meta, alive, q, lo, hi, k):
    ok = alive & np.all((meta >= lo) & (meta <= hi), axis=1)
    idx = np.nonzero(ok)[0]
    ids = np.full((len(q), k), -1)
    dd = np.full((len(q), k), np.inf)
    for i, qi in enumerate(q.astype(np.float64)):
        d = ((x[idx].astype(np.float64) - qi) ** 2).sum(1)
        order = np.argsort(d, kind="stable")[:k]
        ids[i, :len(order)] = idx[order]
        dd[i, :len(order)] = d[order]
    return ids, dd


@pytest.mark.parametrize("n,d,k,seed", [(300, 16, 10, 0), (40, 8, 10, 1),
                                        (500, 96, 5, 2), (7, 4, 10, 3)])
def test_exact_topk_matches_brute_force(n, d, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    meta = rng.uniform(size=(n, 3)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    q = rng.normal(size=(23, d)).astype(np.float32)
    lo = np.array([0.1, 0.0, 0.2], np.float32)
    hi = np.array([0.9, 0.8, 1.0], np.float32)
    ids, dd = reference.exact_topk(torch.as_tensor(x), torch.as_tensor(meta),
                                   torch.as_tensor(alive), torch.as_tensor(q),
                                   lo, hi, k)
    want_i, want_d = _brute(x, meta, alive, q, lo, hi, k)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_allclose(dd.numpy(), want_d, rtol=1e-12)


def test_box_bounds_are_inclusive_in_fp32():
    meta = torch.tensor([[0.25, 0.5, 1.0], [0.25, 0.5, 1.0000001],
                         [0.2499999, 0.5, 0.5]], dtype=torch.float32)
    inside = reference.in_box(meta, [0.25, 0.0, 0.0], [1.0, 0.5, 1.0])
    assert inside.tolist() == [True, False, False]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12), 3.0], dtype=torch.float32)
    got = reference._tf32(t).tolist()
    # ties go to the even mantissa; magnitudes round the same for both signs
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0, 3.0]


@pytest.mark.parametrize("kind", ["tf32", "int4"])
def test_controls_answer_inside_the_filter(kind):
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(400, 32)).astype(np.float32))
    meta = torch.as_tensor(rng.uniform(size=(400, 3)).astype(np.float32))
    alive = torch.ones(400, dtype=torch.bool)
    q = x[:50] + 0.05
    lo, hi = [0.0, 0.0, 0.5], [1.0, 1.0, 1.0]
    ids, dd = reference.control_topk(kind, x, meta, alive, q, lo, hi, 10)
    assert ids.shape == (50, 10) and dd.dtype == torch.float32
    inside = set(reference.candidates(meta, alive, lo, hi).tolist())
    assert set(ids.flatten().tolist()) <= inside
