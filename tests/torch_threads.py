"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs under several pytest-xdist workers on a few cores. PyTorch's
default, one OpenMP thread per core in every worker, oversubscribes them,
and the port's tests, made of many small ops, then wait on threads that
spin for cores other workers hold: one checkpoint test took 93 s in each of
6 concurrent processes on 8 cores against 2.4 s with one thread each. A
port test file imports `one_torch_thread`, a module-scoped autouse fixture,
so its module fixtures and tests run on one thread and the worker's setting
comes back after the file.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
