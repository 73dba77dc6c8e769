"""Generate ``linpde_gp_tpu_torch/data/heat_bench_specs.json``: the
``(scale, terms)`` specs of the heat-equation benchmark kernels
(``bench.py::_build_kernels``: the observation kernel ``H k H*`` and the
cross kernel ``H k``), derived by the JAX package's symbolic layer.

The PyTorch port does not derive specs yet; it reads this file.
``tests/test_torch_specs.py`` holds the file to what the JAX package
derives.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/make_torch_spec_fixtures.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def heat_bench_specs() -> dict:
    """``{"obs": spec, "cross": spec}`` as the JAX package derives them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from bench import _build_kernels
    from linpde_gp_tpu.ops.pallas_gram import kernel_term_specs

    k_hh, k_cross = _build_kernels()
    return {"obs": kernel_term_specs(k_hh), "cross": kernel_term_specs(k_cross)}


def main():
    from linpde_gp_tpu_torch.specs import HEAT_BENCH_SPECS, save_specs

    os.makedirs(os.path.dirname(HEAT_BENCH_SPECS), exist_ok=True)
    save_specs(HEAT_BENCH_SPECS, heat_bench_specs())
    print(f"wrote {HEAT_BENCH_SPECS}")


if __name__ == "__main__":
    main()
