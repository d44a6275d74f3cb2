"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``card``, which run on a CUDA card and skip without one:

    python -m pytest portbench/tests -q            # here: the card's skip
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                                       "without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
