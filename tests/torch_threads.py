"""The port's tests run torch on one thread: their tensors are small, so
one thread is the fastest, and it does not contend with the other test
workers. Every ``tests/test_torch_*.py`` takes the fixture by importing
it: ``from torch_threads import one_torch_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module; the old count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
