"""Fixtures of the benchmark's own tests (no JAX here).

The card decides inside a fixture, never while a module is imported, so
every pytest worker collects the same tests.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (kernel vs twin on the card); "
        "skips without one")


@pytest.fixture
def card():
    """The first CUDA card; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")

