"""Settings of the benchmark's own tests (asmbench/tests).

Tests that need the card carry the `card` marker and take the `card`
fixture, which decides when the test runs, never when the module is
imported, whether a card is there, and skips the test where there is
none.  Run them on a machine with the card:

    python3 -m pytest asmbench/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped where none is seen")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the card")
    return torch.device("cuda")
