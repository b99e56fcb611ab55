"""The benchmark's own tests: CPU runs of every cell at a tiny size (each
cell's sizes and faults in ``cells/<cell>.py``), the readers and the
roofline arithmetic, the exits; one marker, ``card``, for the tests that
need a CUDA card (they skip without one).

    python -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where torch finds no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda")
