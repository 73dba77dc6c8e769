"""Tests of the benchmark's harness.  They run on the CPU at small sizes with
the program's plain versions; a test that needs the card carries the ``card``
marker and is skipped without one (decided in the ``card`` fixture, never at
import).  Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:randomly
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")
    import torch

    # Several workers share the host's cores.
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cpu():
    """The program on the CPU (its plain versions), as in a rehearsal."""
    from linpde_gp_tpu_torch.config import config

    old = config.device
    config.set(device="cpu")
    yield "cpu"
    config.set(device=old)
