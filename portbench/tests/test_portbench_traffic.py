"""The same seed gives the same corpus and traffic; every seed gets the
same amount of work in another order."""
import numpy as np
import pytest
import torch

from portbench import data, generator

from .cells import small_cell


def _make(seed, name="fp32.wide"):
    cell = small_cell(name, live_rows=2000, d=32, batch=16, pool=8)
    corpus = data.make_corpus(cell.config, seed, "cpu")
    pool = generator.make_pool(cell.traffic, cell.config, corpus, seed)
    return cell, corpus, pool


def test_same_seed_same_data_and_traffic():
    big = 2 ** 31 + 977
    _, a, pa = _make(big)
    _, b, pb = _make(big)
    assert torch.equal(a.x, b.x) and torch.equal(a.meta, b.meta)
    np.testing.assert_array_equal(a.s_host, b.s_host)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x.queries, y.queries)
        np.testing.assert_array_equal(x.lo, y.lo)
        np.testing.assert_array_equal(x.hi, y.hi)
    cell = small_cell("fp32.wide", live_rows=2000, d=32)
    np.testing.assert_array_equal(data.pick_deletes(a, cell.config, big),
                                  data.pick_deletes(b, cell.config, big))


def test_seeds_share_the_batches_shapes_in_another_order():
    _, a, pa = _make(11)
    _, b, pb = _make(12)
    assert not torch.equal(a.x, b.x)
    assert not np.array_equal(pa[0].queries, pb[0].queries)
    boxes_a = [(bt.lo.tobytes(), bt.hi.tobytes()) for bt in pa]
    boxes_b = [(bt.lo.tobytes(), bt.hi.tobytes()) for bt in pb]
    assert sorted(boxes_a) == sorted(boxes_b) and boxes_a != boxes_b
    area = sorted(float(np.prod(bt.hi[:2] - bt.lo[:2])) for bt in pa)
    np.testing.assert_allclose(area, 0.25 + 0.75 * (np.arange(8) + 0.5) / 8,
                               rtol=1e-5)


def test_windows_lie_inside_the_corpus_time_span():
    cell, corpus, pool = _make(5)
    t = corpus.s_host[:, 2]
    step = 1.0 / corpus.n
    shares = []
    for bt in pool:
        assert 0.0 < bt.lo[2] < bt.hi[2] <= corpus.now + step
        shares.append(float(bt.hi[2] - bt.lo[2]))
        assert 0.0 <= bt.lo[0] < bt.hi[0] <= 1.0 + 1e-6
        # no arrival time lies within a float32 ulp of a bound
        for bound in (bt.lo[2], bt.hi[2]):
            assert np.min(np.abs(t.astype(np.float32) - bound)) > 0.25 * step
    # every window covers its share of the span, to within the snapping
    np.testing.assert_allclose(
        sorted(shares), 0.5 + 0.5 * (np.arange(8) + 0.5) / 8, atol=2 * step)


def test_deletes_and_live_set_are_the_benchmarks_own():
    cell, corpus, _ = _make(6)
    dead = data.pick_deletes(corpus, cell.config, 6)
    alive = data.live_mask(corpus, dead).numpy()
    assert corpus.n == cell.config["live_rows"]
    assert len(dead) == int(corpus.n * cell.config["delete_fraction"])
    assert len(np.unique(dead)) == len(dead) and not alive[dead].any()
    assert alive.sum() == corpus.n - len(dead)


def test_a_configuration_with_a_ttl_is_refused():
    cell = small_cell("fp32.wide", live_rows=2000, d=32)
    cell.config["stream"]["ttl"] = 0.8
    with pytest.raises(ValueError, match="TTL"):
        data.make_corpus(cell.config, 1, "cpu")
