"""linpde_gp_tpu_torch: the PyTorch/CUDA port of linpde_gp_tpu.

The JAX package ``linpde_gp_tpu`` stays the reference; this package
mirrors its module paths and names and never imports JAX.  Ported so far:

- the dense conditioning engine (:class:`models.gp.GaussianProcess`,
  ``condition_on_observations`` on point and operator observations,
  :class:`models.gp.ConditionalGaussianProcess` with incremental Cholesky
  extension), with random variables, functionals, cross-covariances and
  structured linear algebra, in float64;
- gram-free GP conditioning on operator observations, with any prior mean
  (:class:`models.iterative.IterativeGPRegressor`);
- the symbolic layer: any linear operator on any function (the exact
  shortcuts, else forward-mode autodiff) and on every kernel of the JAX
  package (closed forms for the product and radial Matérn families, the
  general-``nu`` Matérn through a host Bessel call, multi-output and
  parametric kernels, autodiff for the rest), and the closed-form kernel
  specs the CUDA kernels evaluate (``ops/kernels``, ``ops/diffops``,
  ``ops/transforms``);
- the observation model's functionals: point evaluations, Lebesgue
  integrals (exact for half-integer Matérn kernels on intervals, else
  Gauss-Legendre panels), FEM hat-basis L2 projections and weak forms, and
  GP-FEM (Galerkin) conditioning with parametric GPs on the projections.

The public surface mirrors the JAX package's: the reference's aliases
``linfuncops``, ``linfunctls`` and ``randprocs``, ``utils.profiling``
(stage timers, ``torch.profiler`` traces), ``utils.plotting`` (loaded on
first access; needs matplotlib), :func:`entry.entry` (the counterpart of
``__graft_entry__.entry()``) and the numerics experiments
(``python -m linpde_gp_tpu_torch.experiments.run_all``).

Both engines evaluate kernels through hand-written CUDA kernels for Gram
assembly and the Gram matvec (``csrc/gram.cuh``) and the banded matvec of
compactly supported kernels (``csrc/banded.cuh``), compiled per
kernel-spec structure at first use (``ops/_cuda.py``).  Entry points run
on the card; the CPU runs the kernels' plain versions only when asked for
(``device="cpu"`` or ``config.device = "cpu"``), and without a card and
without that request they raise.
"""

import torch

from .config import MODES, config
from . import models, ops
from .models import (
    ConditionalGaussianProcess,
    Constant,
    DeterministicProcess,
    GaussianProcess,
    IterativeGPRegressor,
    Normal,
    ParametricGaussianProcess,
    asrandvar,
    domains,
    functions,
    problems,
    randvars,
)
from .ops import crosscov, diffops, functionals, kernels, linalg, transforms
from . import utils

# The JAX package's aliases of the reference's names (``linfuncops``,
# ``linfunctls``, ``randprocs.covfuncs``).
linfuncops = diffops
linfunctls = functionals


class _RandProcsNamespace:
    """Namespace mirroring ``linpde_gp.randprocs``."""

    covfuncs = kernels
    crosscov = crosscov
    GaussianProcess = GaussianProcess
    ConditionalGaussianProcess = ConditionalGaussianProcess
    IterativeGPRegressor = IterativeGPRegressor
    ParametricGaussianProcess = ParametricGaussianProcess
    DeterministicProcess = DeterministicProcess
    asrandproc = models.asrandproc


randprocs = _RandProcsNamespace

# Full float32 matmuls (the Nyström GEMMs, the Woodbury apply, the refined
# solve's float32 factor): TF32 keeps ~3 decimal digits and breaks CG the
# way bf16 did on the TPU.  Both are torch's defaults; they are stated here
# so nothing relies on it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__all__ = [
    "MODES",
    "config",
    "models",
    "ops",
    "domains",
    "functions",
    "problems",
    "randvars",
    "kernels",
    "diffops",
    "functionals",
    "linfuncops",
    "linfunctls",
    "crosscov",
    "linalg",
    "transforms",
    "randprocs",
    "utils",
    "GaussianProcess",
    "ConditionalGaussianProcess",
    "IterativeGPRegressor",
    "ParametricGaussianProcess",
    "DeterministicProcess",
    "Normal",
    "Constant",
    "asrandvar",
]
