"""The benchmark's own tests: `python -m pytest mvs_bench/tests` from the
repository's root (CPU; the tests marked `cuda` run on a card and skip
without one)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
