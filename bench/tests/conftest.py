import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's kernels); skips without")


@pytest.fixture(autouse=True)
def _one_thread():
    """The tiny runs on one CPU thread: the suite's workers share the
    machine's cores, and many threads a worker slow every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
