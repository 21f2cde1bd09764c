"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests`` from the repository's root)."""

import pytest


@pytest.fixture
def cuda():
    """Skips a test that needs a CUDA card where there is none, deciding
    when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
