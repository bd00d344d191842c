"""A pytest fixture shared by the port's tests that run a threaded pipeline
(the mask stage, the fused path) on the CPU."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test whose pipeline runs torch ops from
    several Python threads at once: with a pool each, on a loaded machine
    their spinning workers slow such a test some fiftyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
