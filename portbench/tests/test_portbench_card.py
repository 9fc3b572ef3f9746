"""The cells at a test's size on the card: the kernels, the profiler's
trace and the per-layer readers, with ``correct`` true. Skips where there
is no card (the ``card`` fixture decides when the test runs). On the
card: ``python3 -m pytest portbench/tests -m card``."""
import pytest

from portbench.lib import harness
from portbench.tests import tiny

LISTED = {w["name"] for w in harness.manifest()["workloads"]}


@pytest.mark.card
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_on_card(card, cell):
    res, checks = tiny.run(cell, 2 ** 31 + 11, 0.5, trace=True, device=card)
    assert res["correct"], checks
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    if cell in LISTED:
        assert res["metrics"], res
