"""One torch intra-op thread for a port test module.

The tier-1 suite runs several test processes side by side on one host;
each would otherwise size torch's CPU thread pool to every core of it.
The port's CPU tests run small batches, so one thread a process loses
them little and spares the other processes. A test module turns this on
by importing the fixture (autouse, module-scoped)::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
