"""The PyTorch port never imports JAX.

``linpde_gp_tpu_torch`` runs on machines without JAX (the GPU machine
has none), so importing any of its modules must succeed with ``jax``
blocked, and no source file of the port or of ``chip_smoke.py`` may
hold an import of it.
"""

import os
import re
import subprocess
import sys

import pytest
import torch
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "linpde_gp_tpu_torch")

_MODULES = [
    "linpde_gp_tpu_torch",
    "linpde_gp_tpu_torch.config",
    "linpde_gp_tpu_torch.specs",
    "linpde_gp_tpu_torch.ops.ff",
    "linpde_gp_tpu_torch.ops.gram",
    "linpde_gp_tpu_torch.ops._cuda",
    "linpde_gp_tpu_torch.k2_probe",
    "linpde_gp_tpu_torch.ops.linalg.chol",
    "linpde_gp_tpu_torch.ops.linalg.pcg",
    "linpde_gp_tpu_torch.models",
    "linpde_gp_tpu_torch.ops",
    "linpde_gp_tpu_torch.ops.linalg",
    "linpde_gp_tpu_torch.utils",
    "linpde_gp_tpu_torch.ops.banded",
    "linpde_gp_tpu_torch.ops.kernels",
    "linpde_gp_tpu_torch.ops.kernels.base",
    "linpde_gp_tpu_torch.ops.kernels.arithmetic",
    "linpde_gp_tpu_torch.ops.kernels.stationary",
    "linpde_gp_tpu_torch.ops.kernels.tensor_product",
    "linpde_gp_tpu_torch.ops.kernels.wendland",
    "linpde_gp_tpu_torch.ops.kernels.bessel",
    "linpde_gp_tpu_torch.ops.kernels.multioutput",
    "linpde_gp_tpu_torch.ops.diffops",
    "linpde_gp_tpu_torch.ops.diffops.coefficients",
    "linpde_gp_tpu_torch.ops.diffops.linfuncop",
    "linpde_gp_tpu_torch.ops.diffops.lindiffop",
    "linpde_gp_tpu_torch.ops.transforms",
    "linpde_gp_tpu_torch.ops.transforms.univariate",
    "linpde_gp_tpu_torch.ops.transforms.product",
    "linpde_gp_tpu_torch.ops.transforms.dispatch",
    "linpde_gp_tpu_torch.ops.transforms.autodiff",
    "linpde_gp_tpu_torch.ops.transforms.radial",
    "linpde_gp_tpu_torch.utils.shapes",
    "linpde_gp_tpu_torch.utils.serialization",
    "linpde_gp_tpu_torch.models.functions",
    "linpde_gp_tpu_torch.models.functions.base",
    "linpde_gp_tpu_torch.models.functions.polynomial",
    "linpde_gp_tpu_torch.models.gp",
    "linpde_gp_tpu_torch.models.iterative",
    "linpde_gp_tpu_torch.models.randvars",
    "linpde_gp_tpu_torch.models.randprocs",
    "linpde_gp_tpu_torch.ops.linalg.linops",
    "linpde_gp_tpu_torch.ops.linalg.covariance",
    "linpde_gp_tpu_torch.ops.linalg.refine",
    "linpde_gp_tpu_torch.ops.functionals",
    "linpde_gp_tpu_torch.ops.functionals.base",
    "linpde_gp_tpu_torch.ops.functionals.evaluation",
    "linpde_gp_tpu_torch.ops.crosscov",
    "linpde_gp_tpu_torch.ops.crosscov.base",
    "linpde_gp_tpu_torch.ops.transforms.functionals",
    "linpde_gp_tpu_torch.ops.kron_ff",
    "linpde_gp_tpu_torch.models.domains",
    "linpde_gp_tpu_torch.models.domains.domain",
    "linpde_gp_tpu_torch.models.domains.grid",
    "linpde_gp_tpu_torch.models.functions.arithmetic",
    "linpde_gp_tpu_torch.models.functions.basic",
    "linpde_gp_tpu_torch.models.problems",
    "linpde_gp_tpu_torch.models.problems.pde",
    "linpde_gp_tpu_torch.models.functions.fem",
    "linpde_gp_tpu_torch.models.functions.bases",
    "linpde_gp_tpu_torch.models.parametric",
    "linpde_gp_tpu_torch.ops.functionals.integrals",
    "linpde_gp_tpu_torch.ops.functionals.projections",
    "linpde_gp_tpu_torch.ops.functionals.projections_ns",
    "linpde_gp_tpu_torch.ops.functionals.projections_ns.l2",
    "linpde_gp_tpu_torch.ops.functionals.weak_forms",
    "linpde_gp_tpu_torch.ops.transforms.integrals_exact",
    "linpde_gp_tpu_torch.ops.kernels.parametric",
    "linpde_gp_tpu_torch.native",
    "linpde_gp_tpu_torch.native.engine",
    "linpde_gp_tpu_torch.parallel",
    "linpde_gp_tpu_torch.parallel.mesh",
    "linpde_gp_tpu_torch.parallel.launch",
    "linpde_gp_tpu_torch.parallel.gram",
    "linpde_gp_tpu_torch.parallel.cholesky",
    "linpde_gp_tpu_torch.parallel.extend",
    "linpde_gp_tpu_torch.parallel.solve",
    "linpde_gp_tpu_torch.parallel.posterior",
    "linpde_gp_tpu_torch.parallel.iterative",
    "linpde_gp_tpu_torch.parallel.dryrun",
    "linpde_gp_tpu_torch.utils.profiling",
    "linpde_gp_tpu_torch.entry",
    "linpde_gp_tpu_torch.experiments",
    "linpde_gp_tpu_torch.experiments.common",
    "linpde_gp_tpu_torch.experiments.poisson_1d",
    "linpde_gp_tpu_torch.experiments.poisson_2d",
    "linpde_gp_tpu_torch.experiments.heat_1d",
    "linpde_gp_tpu_torch.experiments.poisson_fem",
    "linpde_gp_tpu_torch.experiments.poisson_1d_inverse_rhs",
    "linpde_gp_tpu_torch.experiments.cpu_thermal_1d",
    "linpde_gp_tpu_torch.experiments.cpu_thermal_2d",
    "linpde_gp_tpu_torch.experiments.run_all",
    "linpde_gp_tpu_torch.experiments.figures",
    "linpde_gp_tpu_torch.experiments.scaling",
    "linpde_gp_tpu_torch.experiments.gram_noise_floor",
    "linpde_gp_tpu_torch.experiments.wendland_banded",
    "linpde_gp_tpu_torch.experiments.large_scale",
    "linpde_gp_tpu_torch.experiments.grid_mode",
    "linpde_gp_tpu_torch.experiments.variance",
    "linpde_gp_tpu_torch.experiments.precond_spectroscopy",
]
#: Modules checked elsewhere: plotting needs matplotlib, which the GPU
#: machine lacks (``test_torch_plotting.py``, ``test_torch_surface.py``).
_TESTED_APART = ["linpde_gp_tpu_torch.utils.plotting"]


def test_module_list_covers_the_package():
    """Every module of the port is in the blocked-import check above."""
    found = set()
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[: -len(".py")].replace(os.sep, ".")
                found.add(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    assert found <= set(_MODULES) | set(_TESTED_APART), sorted(found - set(_MODULES) - set(_TESTED_APART))


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        + "".join(f"import {m}\n" for m in _MODULES)
        + "from linpde_gp_tpu_torch.specs import load_specs\n"
        "load_specs()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'linpde_gp_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_spawned_rank_imports_no_jax():
    """A rank spawned by ``parallel/launch.spawn`` from this process (which
    holds JAX) runs a case of the port and holds no module of JAX or of the
    JAX package."""
    from linpde_gp_tpu_torch.parallel.dryrun import rank_cases
    from linpde_gp_tpu_torch.parallel.launch import spawn

    cases = [("A", "cholesky", dict(A=[[4.0, 2.0], [2.0, 3.0]], nb=1, layout="cyclic"))]
    (out,) = spawn(rank_cases, 1, (cases,), timeout=120)
    assert out["world"] == 1 and out["jax_loaded"] == []


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_statement(path):
    with open(path) as fh:
        src = fh.read()
    pattern = r"^\s*(import\s+(jax|jaxlib|linpde_gp_tpu)\b|from\s+(jax|jaxlib|linpde_gp_tpu)\b)"
    assert not re.findall(pattern, src, flags=re.M)
