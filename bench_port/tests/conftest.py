"""The benchmark's own tests (CPU; a test that needs a CUDA card carries the
``card`` marker and skips without one)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
