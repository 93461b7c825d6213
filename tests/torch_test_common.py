"""Fixtures shared by the port's test files (tests/test_torch_*.py).  A
file takes one by importing it by name (pytest collects a fixture from a
test module's namespace, imported or not)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the importing file (the suite runs several
    workers, and a worker's idle pool threads spinning against the
    others' slow every small operation many times over); restored after
    the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
