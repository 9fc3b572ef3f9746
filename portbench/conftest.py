"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the marker of tests that need the card, and the
checkout on the import path before any installed copy of the port."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs, never when
    a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return torch.device("cuda:0")
