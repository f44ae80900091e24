"""The benchmark's own tests (CPU; those marked ``gpu`` skip without a card).

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only "
                    "the card has")
    return torch.device("cuda", 0)
