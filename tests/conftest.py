import numpy as np
import pytest

# NOTE: no XLA_FLAGS device-count override here — smoke tests and benches
# must see 1 device (the dry-run sets 512 itself, in its own process).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute integration tests (subprocess meshes)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's kernels); skips without")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
