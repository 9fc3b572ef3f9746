"""The controls fail: at a test's size, on several seeds, each cell's
control reads above the limit of 0 in one of the cell's numbers."""
import pytest

from portbench.lib import control
from portbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_control_fails(cell, seed):
    w = tiny.cell(cell)
    config = tiny.config(w["config"])
    traffic = tiny.traffic(w["traffic"])
    found = control.readings(w, config, traffic, seed, "cpu")
    assert max(found.values()) > 0, found
