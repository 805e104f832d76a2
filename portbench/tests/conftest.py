"""The benchmark's own tests: ``python -m pytest portbench/tests``.
Tests that need a CUDA card carry the ``cuda`` marker and skip, from a
fixture, where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the CPU runs are tiny, and parallel
    test workers each with a full pool oversubscribe the host."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
