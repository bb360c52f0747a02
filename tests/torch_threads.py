"""One intra-op thread for the port's tests on the CPU.

The suite runs in several worker processes at once, and PyTorch gives each
of them an OpenMP pool as wide as the machine.  The port's CPU tests launch
many small operations, and an oversubscribed pool spins and waits at every
parallel region: a test that takes a second alone took minutes beside the
other workers.  A test module imports the fixture below, which runs each of
its tests with one intra-op thread and restores the pool's width after::

    from torch_threads import one_intra_op_thread  # noqa: F401

The thread count changes no result the tests compare: every comparison is of
integer words, events or tolerance-stated floats, on the same inputs.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
