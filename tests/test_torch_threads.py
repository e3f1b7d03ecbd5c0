"""A fixture for the port's test modules: two intra-op threads for torch
while a module runs, the count before restored after it.  The suite runs
several test processes at once (pytest-xdist), and torch would otherwise
start one thread per core in each.  A module takes it with
``from test_torch_threads import few_torch_threads  # noqa: F401`` (autouse).
This module holds no test of its own."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
