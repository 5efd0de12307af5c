"""The benchmark's own tests: ``python -m pytest perfbench/tests``. They
import no JAX. Tests marked ``cuda`` need a card and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the benchmark's comparison at "
        "the card's precision)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"
