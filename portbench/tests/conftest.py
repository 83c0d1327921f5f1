"""The benchmark's tests.  ``card`` marks a test that needs a CUDA device:
it decides inside its fixture, never at import, and skips on a machine
without one.  Run them all with

    python -m pytest portbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip, skips elsewhere)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the chip")
    return torch.device("cuda", 0)
