"""Tests of the benchmark (portbench/), run on the CPU with

    python -m pytest portbench/tests -q

Those marked `cuda` need a card and skip elsewhere; the chip runs them as
`python -m pytest portbench/tests -q -m cuda`."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
