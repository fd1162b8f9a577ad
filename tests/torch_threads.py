"""One torch thread for a port test file.

A port test file imports the fixture into its namespace, where pytest finds
it, and every test of the file then runs with one torch thread:

    from tests.torch_threads import one_torch_thread  # noqa: F401

The suite runs six worker processes on a host of a few cores, each beside
JAX's own thread pool. The models of these tests are small, so more torch
threads a process only wait for cores that the other workers hold (one
test read 296 s on eight threads under six workers and 17 s on one).
``tests/test_torch_port_threads.py`` holds every port test file to this.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's thread count set to 1 for the module, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
