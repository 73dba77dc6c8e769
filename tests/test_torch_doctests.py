"""The port's docstring examples on the modules whose JAX counterparts
``tests/test_doctests.py`` runs, with the values the JAX docstrings give;
each module must carry at least one example."""

import doctest
import importlib

import pytest
import torch

from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
config.set(device="cpu")

MODULES = [
    "linpde_gp_tpu_torch.models.gp",
    "linpde_gp_tpu_torch.models.iterative",
    "linpde_gp_tpu_torch.models.domains.domain",
    "linpde_gp_tpu_torch.models.randvars",
    "linpde_gp_tpu_torch.ops.kernels.stationary",
    "linpde_gp_tpu_torch.ops.kernels.tensor_product",
    "linpde_gp_tpu_torch.ops.diffops.lindiffop",
    "linpde_gp_tpu_torch.ops.transforms.dispatch",
    "linpde_gp_tpu_torch.ops.functionals.integrals",
    "linpde_gp_tpu_torch.ops.linalg.pcg",
    "linpde_gp_tpu_torch.utils.profiling",
]


@pytest.mark.parametrize("mod", MODULES)
def test_doctests(mod):
    saved = config.device
    try:
        result = doctest.testmod(importlib.import_module(mod), optionflags=doctest.NORMALIZE_WHITESPACE)
    finally:
        config.device = saved
    assert result.failed == 0, f"{result.failed} doctest failure(s) in {mod}"
    assert result.attempted > 0, f"no doctest examples found in {mod}"
