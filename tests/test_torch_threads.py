"""One intra-op thread for the port's heaviest CPU test files.

The suite runs on several worker processes at once, and at the tiny test
widths a torch op's intra-op threads (one per core by default) only
contend with the other workers' threads.  A test file imports
``one_intra_op_thread`` to run on one intra-op thread and restore the
count after its last test: with the port's slowest files on one thread,
a six-worker run of the whole suite on an 8-core CPU host took 491.9 s,
against 1328.9 s with every file on eight.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the importing module's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_module_that_imports_the_fixture_runs_on_one_thread():
    assert torch.get_num_threads() == 1
