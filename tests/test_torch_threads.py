"""One torch thread while a port test module runs.

The suite runs one process a core (`pytest -n`), and torch's intra-op
pool on top of that oversubscribes the cores, which slows the engine's
many small ops tenfold or more. Every port test module that runs torch
work takes this module-scoped autouse fixture by importing it:

    from test_torch_threads import _one_torch_thread  # noqa: F401

and it holds here too.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
