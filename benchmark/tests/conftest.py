"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``): the ``cuda`` marker, and toy cells for CPU runs."""

import pytest
import torch

from benchmark import run


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def toy_spec(cell: str, gaussians: int = 3000, width: int = 100,
             height: int = 70) -> dict:
    """A cell's spec at a toy size: its traffic, limits and metrics as
    committed, its configuration cut to ``gaussians`` at
    ``width`` x ``height``."""
    spec = run.load_spec(cell)
    spec["config"] = dict(spec["config"], gaussians=gaussians, width=width,
                          height=height)
    return spec
