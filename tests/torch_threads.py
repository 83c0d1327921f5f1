"""A module-scoped autouse fixture that runs a gomavatar_tpu_torch test module
on one torch thread, restoring the thread count after it.

The suite runs in several pytest-xdist workers, each with torch's and XLA's
thread pools sized to every core; the port's many small CPU ops then spend
their time contending for the cores (the port's test files took 404 s on six
workers on an eight-core host, and 113 s with this fixture in each).  Import
it into a test module to apply it there:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
