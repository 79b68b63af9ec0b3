"""The benchmark's own tests: on the CPU (pure Python and the port's plain
versions at a tiny size), and marked ``cuda`` where they need the card.

    python -m pytest portbench/tests -q            # here: the card's tests skip
    python3 -m pytest portbench/tests -q -m cuda   # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where CUDA is not available")


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# A cell cut to a size the CPU runs in seconds: 2 replicas, 0.6 s of
# sequence (5 calls; 1.8 s, 2 chunks, chunked), the cells' 8,000 points a
# scan.
TINY = {"replicas": 2, "sequence_s": 0.6, "scan_points": 8000}
TINY_C8 = {"replicas": 2, "sequence_s": 1.8, "scan_points": 8000}


def tiny(cell):
    return TINY_C8 if cell.endswith("_c8") else TINY
