"""pytest settings of the benchmark's own tests (`cardbench/tests`): the
`card` marker. A card test asks for the `cuda` fixture, which skips it
where no CUDA device is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")
