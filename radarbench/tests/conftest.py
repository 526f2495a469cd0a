"""The benchmark's own tests (``python -m pytest radarbench/tests``).  Tests
that need the card carry the ``cuda`` marker and skip without one; whether
there is a card is decided in a fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda:0")
