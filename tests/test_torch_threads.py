"""The port's test modules cap torch's intra-op threads.

The suite runs in several worker processes at once.  Torch's default of
one intra-op thread per core, in each worker that runs a ``test_torch_*``
module, oversubscribes the cores, and timing tests in the other workers
then miss their limits.  Each port test module imports the module-scoped
autouse fixture ``torch_threads``: it caps the threads for the module's
tests and restores the earlier count after them.

With ``TORCH_TEST_TIMES=<file>`` set, the fixture also appends one JSON
line per module to that file: the xdist worker, the module's wall-clock
start and end, its wall seconds, the CPU seconds its worker process
spent meanwhile (every thread of it: torch's, XLA's, the servers') and
the worker's OS thread count at the end - the load a port module puts
beside the timing tests of other workers.
"""

import contextlib
import json
import os
import time

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


def _os_threads() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


@pytest.fixture(autouse=True, scope="module")
def torch_threads(request):
    out = os.environ.get("TORCH_TEST_TIMES")
    t0, c0 = time.time(), time.process_time()
    with capped_threads() as n:
        yield n
    if out:
        t1 = time.time()
        row = {
            "module": request.module.__name__,
            "worker": os.environ.get("PYTEST_XDIST_WORKER", "main"),
            "start": t0, "end": t1, "wall_s": round(t1 - t0, 3),
            "cpu_s": round(time.process_time() - c0, 3),
            "os_threads": _os_threads(),
        }
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")


def test_threads_capped_inside_the_module_and_restored_after(torch_threads):
    assert torch.get_num_threads() == torch_threads == THREADS
    with capped_threads(3):
        assert torch.get_num_threads() == 3
    assert torch.get_num_threads() == THREADS
