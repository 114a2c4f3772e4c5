"""The benchmark's own tests (``python -m pytest benchmark/tests``): CPU tests
at small sizes, and tests marked ``card`` that need an NVIDIA GPU and skip
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test runs the cell at its own size")
    return "cuda"
