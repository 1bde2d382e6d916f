"""One torch intra-op thread for a port test module, put back after it.

The tier-1 run spreads the test files over parallel workers on the
machine's cores, and each worker's default pool holds a thread per core:
the pools' barriers then cost many times the tiny CPU ops these tests
run.  A module opts in by importing the fixture."""
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
