"""pytest settings of the benchmark's own tests (benchmark/tests/): the
marker of tests that need a CUDA card, and the fixture that decides, when
a test runs, whether there is one.

    python -m pytest benchmark/tests -q           # CPU; card tests skip
    python -m pytest benchmark/tests -q -m gpu    # on the card
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the sweep kernels have no CPU "
        "mode); skipped without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the sweep kernels run only on one")
    return torch.device("cuda", 0)
