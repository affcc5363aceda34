"""The torch thread count of the port's tests, decided once.

Every ``tests/test_torch_*.py`` module imports the fixture:

    from torch_threads import one_torch_thread  # noqa: F401

The port's tests are small-op loops at toy shapes: they gain nothing from
more than one intra-op thread, and beside other test workers the extra
threads only contend.  The fixture is module-scoped and autouse, so pytest
sets it up before the module-scoped fixtures that compute the JAX references
and the port's runs.  It acts only while its module runs: nothing is set at
import, when every worker imports every test module.  A test that starts a
process passes ``OMP_NUM_THREADS=1`` in the child's environment.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module; the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
