"""pytest settings of the benchmark's own tests (``python -m pytest portbench``):
the checkout's root and ``src`` on the path, and the ``card`` marker for
tests that need a CUDA card, which skip elsewhere (decided in the ``card``
fixture, never while a module is imported)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
