"""On the card: each cell of ``BENCHMARK.json`` at its own size, over a
short window, comes out correct (``python3 -m pytest -m cuda
portbench/tests``)."""
import pytest

from portbench import run, spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["fp32.wide", "int8.wide"])
def test_cell_is_correct_on_the_card(card, cell_name):
    cell = spec.load_cell(cell_name)
    res = run.run_cell(cell, 2 ** 31 + 99, 2.0, False, device=str(card))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
