"""The check has to fail its control: the reference in the program's
place, computed in float32, comes out not correct in every cell (at a
size a test run holds; ``control.py`` reads it at the cells' own size
on the card's host)."""

import pytest

from olap_bench import control
from olap_bench.tests.common import CELLS, SCALE


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 2 ** 33 + 5])
def test_control_is_not_correct(cell, seed):
    rec = control.readings(cell, seed, SCALE[cell] * 4)
    assert not rec["correct"]
    assert rec["max_rel_err"] > 3 * rec["limit"]
