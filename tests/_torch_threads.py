"""One torch intra-op thread while a CPU test module of the port runs.

The suite runs under pytest-xdist, several workers on one machine, and by
default torch gives every worker one intra-op thread per core: the cores
are oversubscribed and the threads' waits cost far more than these
tests' small tensors gain from them. Each CPU test module of the port
imports this autouse fixture; the count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
