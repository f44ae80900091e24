"""Torch's CPU threads for the port's heavier test modules.

pytest-xdist runs several workers on one machine, and torch starts one
intra-op thread per core in each of them; its OpenMP threads then contend
for the cores and a module runs many times slower than alone. A module that
imports ``torch_threads_per_worker`` gives each worker its share of the cores
for its own tests and restores the count afterwards.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
