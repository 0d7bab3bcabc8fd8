"""One torch intra-op thread for the port's CPU verify tests.

The plain torch comb runs on tensors of a few hundred rows, where intra-op
threads gain nothing, and under pytest-xdist every worker process would
start a thread pool as wide as the machine on the same cores: the tests
then run several times slower than in one process. A test module imports
:func:`one_torch_thread`; being autouse, it holds for that module only and
restores the previous count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
