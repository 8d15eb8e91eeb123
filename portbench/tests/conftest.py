"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the root of the repository (on a card too, where the ``cuda`` tests
run)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: each cell at a size a CPU test run holds (traffic parameters replaced)
SMALL = {
    "train_b16": {"batch": 4, "hw": [64, 128], "pool": 3,
                  "warmup_steps": 1, "trace_steps": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    return torch.device("cuda", 0)
