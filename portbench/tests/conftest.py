"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout (the CPU ones), and on a machine with a card
``python -m pytest portbench/tests -q -m card`` (the control's readings)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)
