"""The kernel specs the PyTorch port carries as data.

``linpde_gp_tpu_torch/data/heat_bench_specs.json`` must equal, tuple for
tuple, what the JAX package's symbolic layer derives for
``bench.py::_build_kernels`` today (regenerate it with
``tests/make_torch_spec_fixtures.py`` when the derivation changes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from make_torch_spec_fixtures import heat_bench_specs
from linpde_gp_tpu_torch.specs import load_specs, save_specs, spec_diagonal, to_tuple
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


@pytest.fixture(scope="module")
def jax_specs():
    return heat_bench_specs()


@pytest.mark.parametrize("name", ["obs", "cross"])
def test_heat_bench_specs_match_jax(jax_specs, name):
    ported = load_specs()[name]
    derived = jax_specs[name]
    assert ported == derived
    # Same Python types, not just equal values: the spec is a cache key.
    assert ported == to_tuple(derived)
    assert hash(ported) == hash(to_tuple(derived))


def test_specs_round_trip(tmp_path, jax_specs):
    path = tmp_path / "specs.json"
    save_specs(str(path), jax_specs)
    assert load_specs(str(path)) == {k: to_tuple(v) for k, v in jax_specs.items()}


def test_spec_diagonal_is_k_at_zero_lag():
    """``spec_diagonal`` equals the JAX kernels evaluated at ``(x, x)``."""
    from bench import _build_kernels

    k_hh, k_cross = _build_kernels()
    specs = load_specs()
    x = jnp.asarray(np.array([[1.3, -0.2]]))
    for k, name in ((k_hh, "obs"), (k_cross, "cross")):
        want = float(np.asarray(k(x, x))[0])
        assert abs(spec_diagonal(specs[name]) - want) <= 1e-14 * max(abs(want), 1.0)
