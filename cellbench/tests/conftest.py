"""The benchmark's own tests: `python -m pytest cellbench/tests -q`.

They run on the CPU. A test that needs the card takes the `cuda_card`
fixture, which skips without one; whether a card is there is decided inside
the fixture, never while a module is imported."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
