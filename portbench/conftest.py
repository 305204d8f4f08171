"""pytest settings of the benchmark's own tests (portbench/tests/).

    python -m pytest portbench/tests -q            # the CPU tests
    python -m pytest portbench/tests -q -m card    # on a CUDA card

Tests marked ``card`` need a CUDA device; the ``cuda_device`` fixture
decides at run time and skips them elsewhere.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
