"""The benchmark's own tests (`benchmark/tests/`). Tests that need the CUDA
card carry the `card` marker and take the `card` fixture, which skips them
where no card is present; the decision is made when the test runs, never
when a module is imported.

    python -m pytest benchmark/tests -q -p xdist -n 6 --dist loadfile
    python -m pytest benchmark/tests -q -m card -o addopts=   # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this host has none")
    return torch.device("cuda")
