"""The control, one precision step below the configuration in the
program's place, comes out as not correct under each cell's limits; the
reference itself comes out correct.  fp32.wide's step is TF32; int8.wide's
is int4 codes under the same exact rerank (its answers also carry fp32
distances, so TF32 is held against it too).  (At the cells' own size on
the card: ``python3 -m portbench.control``; here at a size a test run
holds.)"""
import pytest

from portbench import control

from .cells import small_cell

SEEDS = (3, 2 ** 31 + 17)


# int4 codes lose neighbours only where a box holds many rows near each
# query: int8.wide's control runs on 32,000 rows
@pytest.mark.parametrize("cell_name,kinds,rows,batch", [
    ("fp32.wide", ("tf32",), 4000, 256),
    ("int8.wide", ("tf32", "int4"), 32000, 128)])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_reference_passes(cell_name, kinds, rows, batch,
                                            seed):
    cell = small_cell(cell_name, live_rows=rows, d=768, batch=batch, pool=2)
    res = control.control_numbers(cell, seed, ("exact",) + kinds, "cpu")
    assert res["exact"]["correct"], res["exact"]["checks"]
    assert res["exact"]["numbers"]["bad_answers"] == 0
    for kind in kinds:
        assert not res[kind]["correct"], (kind, res[kind]["checks"])
