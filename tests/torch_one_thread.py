"""One intra-op thread for the port's CPU tests (tests/test_torch_port_*.py).

The whole suite runs under six pytest-xdist workers (ROADMAP.md's Tier-1
verify command), and PyTorch gives each process an intra-op thread pool as
wide as the machine: on eight cores the pools then wait on each other's
cores, and six of the port's files that take 2 minutes together under six
workers with one thread each took 12 minutes with the default pools.  The port's tests run at tiny widths, where one thread is as
fast alone, and so do the port's CPU ranks (parallel/ddp.py).  Each file
imports `one_intra_op_thread`, which pytest then applies to each of its
tests; the worker's own count comes back after the file.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
