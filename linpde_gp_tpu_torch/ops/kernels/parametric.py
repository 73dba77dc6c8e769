"""Parametric and Galerkin covariance functions.

Port of ``linpde_gp_tpu/ops/kernels/parametric.py``:
``ParametricCovarianceFunction`` (``phi(x0)^T Sigma phi(x1)``) and
``GalerkinCovarianceFunction`` (the ``k -> P k P*`` decomposition of the
FEM-projected process, caching ``k P*`` and ``P k P*``).
"""

from __future__ import annotations

import torch

from ..linalg.covariance import Covariance
from .base import CovarianceFunction


class ParametricCovarianceFunction(CovarianceFunction):
    """``k(x0, x1) = phi(x0)^T Sigma phi(x1)`` for a feature (basis) function ``phi``."""

    def __init__(self, basis, cov: Covariance):
        if cov.shape1 != basis.output_shape:
            raise ValueError("cov.shape1 must equal basis.output_shape")
        self._basis = basis
        self._cov = cov
        super().__init__(basis.input_shape)

    @property
    def basis(self):
        return self._basis

    @property
    def cov(self) -> Covariance:
        return self._cov

    def _evaluate(self, x0, x1):
        phi0 = self._basis(x0)
        phi1 = self._basis(x1)
        return torch.einsum("...i,ij,...j->...", phi0, self._cov.matrix.to(phi0), phi1)


class _EmbeddedCrossCovarianceKernel(CovarianceFunction):
    """``(x0, x1) -> kPa(x0) . phi(x1)``: a crosscov embedded as a kernel
    through the basis."""

    def __init__(self, pv_crosscov, basis):
        self._pv_crosscov = pv_crosscov
        self._basis = basis
        super().__init__(pv_crosscov.randproc_input_shape)

    def _evaluate(self, x0, x1):
        vals = self._pv_crosscov.evaluate(x0)  # batch0 + (m,)
        return torch.sum(vals * self._basis(x1).to(vals), dim=-1)


class GalerkinCovarianceFunction(CovarianceFunction):
    """Covariance of the Galerkin-projected process: ``k - k P* phi - phi P k +
    2 phi (P k P*) phi``, the JAX package's algebra."""

    def __init__(self, covfunc: CovarianceFunction, projection):
        from ..crosscov.base import apply_functional_to_crosscov
        from ..transforms.functionals import apply_functional

        self._covfunc = covfunc
        self._projection = projection
        self._kPa = apply_functional(projection, covfunc, argnum=1)
        self._PkPa = apply_functional_to_crosscov(projection, self._kPa)
        self._kPaP = _EmbeddedCrossCovarianceKernel(self._kPa, basis=projection.basis)
        self._PaPkPaP = ParametricCovarianceFunction(projection.basis, cov=self._PkPa)
        super().__init__(covfunc.input_shape, covfunc.output_shape_0, covfunc.output_shape_1)

    @property
    def P(self):
        return self._projection

    @property
    def PkP(self) -> Covariance:
        return self._PkPa

    @property
    def kPa(self):
        return self._kPa

    def _evaluate(self, x0, x1):
        papkpap = self._PaPkPaP._evaluate(x0, x1)
        return (
            papkpap
            + self._covfunc._evaluate(x0, x1)
            - self._kPaP._evaluate(x0, x1)
            - self._kPaP._evaluate(x1, x0)
            + papkpap
        )
