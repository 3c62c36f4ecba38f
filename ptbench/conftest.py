"""pytest settings of the benchmark's own tests (``ptbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips where there is none (decided in a fixture)")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two CPU threads a test process: several workers that each run a
    thread a core slow one another down by far more than they gain."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """``"cuda"``, or a skip where the process sees no GPU."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture
def cuda_absent():
    """A skip where the process sees a GPU: the test is of the run without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
