"""An autouse fixture for the port's CPU tests at small shapes: one torch
intra-op thread.  At these sizes a team of threads costs more than it
gives, and its spinning takes cores from the other test processes, some
of which time their own work.  Import it into a test module to apply it
there:

    from _torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
