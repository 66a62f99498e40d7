"""Fixture shared by the port's CPU tests: torch's intra-op threads are
capped while a test module runs. The suite runs in several pytest-xdist
workers on one machine, and torch's default of one OpenMP thread per core
in every worker oversubscribes the cores the JAX tests run on."""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)
