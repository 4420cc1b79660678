"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need a CUDA card; they take the ``card`` fixture,
which skips them where there is none (decided when the test runs, never at
import).  On a card: ``python -m pytest benchmark/tests -q -m card``.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return "cuda"
