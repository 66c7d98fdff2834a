"""The benchmark's own tests (``portbench/tests``): run them with
``python -m pytest portbench/tests``. Tests that need an NVIDIA card carry
the ``card`` marker and take the ``card`` fixture, which skips them where
there is none: the choice is made when a test runs, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
