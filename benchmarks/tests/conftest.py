"""The benchmark's tests: CPU tests at small sizes, and tests marked
``chip`` that need a CUDA device (each decides so in its fixture)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
