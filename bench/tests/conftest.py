import pytest


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several worker processes side by side: one torch
    thread each keeps these small runs from fighting over the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
