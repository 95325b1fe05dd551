"""The port's test modules cap torch's intra-op threads.

The suite runs in several worker processes at once.  Torch's default of
one intra-op thread per core, in each worker that runs a ``test_torch_*``
module, oversubscribes the cores, and timing tests in the other workers
then miss their limits.  Each port test module imports the module-scoped
autouse fixture ``torch_threads``: it caps the threads for the module's
tests and restores the earlier count after them.
"""

import contextlib

import pytest
import torch

THREADS = 1  # the port's CPU tests run small shapes: one thread is enough


@contextlib.contextmanager
def capped_threads(n: int = THREADS):
    """torch.set_num_threads(n) inside the block, the earlier count after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield n
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    with capped_threads() as n:
        yield n


def test_threads_capped_inside_the_module_and_restored_after(torch_threads):
    assert torch.get_num_threads() == torch_threads == THREADS
    with capped_threads(3):
        assert torch.get_num_threads() == 3
    assert torch.get_num_threads() == THREADS
