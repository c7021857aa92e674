"""The benchmark's own tests: `python -m pytest ptbench/tests -q` from the
repository's root.  They run on the CPU at tiny sizes, where the program
runs its plain PyTorch paths; the tests marked `chip` need a CUDA card and
skip without one (`python -m pytest ptbench/tests -m chip` on the card)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    return "cuda:0"
