"""A whole run on the CPU (the port's plain twins, no card check) with
the timed path broken underneath: ``correct`` comes out false for each
fault a query cell can have (half of the batch left out, an answer
altered where it is produced, sound rows that are not the nearest), and
true without one."""
import numpy as np
import pytest

from portbench import run

from .cells import small_cell

SEED = 2 ** 31 + 4242


def _answer(self, queries, filt, k=10, **kw):
    from repro_torch.streaming import SegmentManager
    return SegmentManager.query(self, queries, filt, k=k, **kw)


def half_left_out(self, queries, filt, k=10, **kw):
    """Half of the batch's queries come back unanswered."""
    out = _answer(self, queries, filt, k=k, **kw)
    g, d = out[0].copy(), out[1].copy()
    g[len(g) // 2:] = -1
    d[len(d) // 2:] = np.inf
    return (g, d) + tuple(out[2:])


def answer_altered(self, queries, filt, k=10, **kw):
    """One query's nearest id is swapped for another query's id."""
    out = _answer(self, queries, filt, k=k, **kw)
    g = out[0].copy()
    other = [v for v in g[1] if v >= 0 and v not in g[0]]
    if other:
        g[0, 0] = other[-1]
    return (g, out[1]) + tuple(out[2:])


def far_neighbours(self, queries, filt, k=10, **kw):
    """Live rows inside the box with their true distances, but the
    (k+1)-th to 2k-th nearest instead of the k nearest."""
    out = _answer(self, queries, filt, k=2 * k, **kw)
    return (out[0][:, k:].copy(), out[1][:, k:].copy()) + tuple(out[2:])


@pytest.mark.parametrize("cell_name", ["fp32.wide", "int8.wide"])
@pytest.mark.parametrize("fault,trace", [(None, False), (half_left_out, False),
                                         (answer_altered, False),
                                         (far_neighbours, False),
                                         (answer_altered, True)])
def test_fault_in_the_timed_path_fails_correct(cell_name, fault, trace):
    cell = small_cell(cell_name)
    res = run.run_cell(cell, SEED, 0.3, trace, device="cpu",
                       program_query=fault)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] > 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if fault is half_left_out:
        assert res["failed"] > 0
