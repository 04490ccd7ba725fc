"""The benchmark's CPU tests. Run from the repository root:

    python -m pytest perfbench/tests -q

Tests that need a card take the `card` fixture, which skips without one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
