"""Weight-space ("parametric") Gaussian processes: ``u(x) = phi(x)^T w``
with Gaussian weights.

Port of ``linpde_gp_tpu/models/parametric.py``.  The process lives on its
weights' device: the mean and the covariance are evaluated there.
"""

from __future__ import annotations

import torch

from ..config import as_f64
from ..ops.kernels.base import CovarianceFunction
from .functions.base import Function
from .gp import GaussianProcess
from .randvars import Normal


class _ParametricMean(Function):
    def __init__(self, weights: Normal, feature_fn: Function):
        self._weights = weights
        self._feature_fn = feature_fn
        super().__init__(feature_fn.input_shape, ())

    def __call__(self, x):
        return super().__call__(as_f64(x, self._weights.mean.device))

    def _evaluate(self, x):
        phi = self._feature_fn._evaluate(x)
        mean = self._weights.mean.to(phi)
        if self._feature_fn.output_shape == ():
            return phi * mean
        return phi @ mean


class _ParametricCov(CovarianceFunction):
    def __init__(self, weights: Normal, feature_fn: Function):
        self._weights = weights
        self._feature_fn = feature_fn
        super().__init__(feature_fn.input_shape)

    def _evaluate(self, x0, x1):
        phi0 = self._feature_fn._evaluate(x0)
        phi1 = self._feature_fn._evaluate(x1)
        sigma = self._weights.cov.matrix.to(phi0)
        if self._feature_fn.output_shape == ():
            return phi0 * sigma.reshape(()) * phi1
        return torch.einsum("...i,ij,...j->...", phi0, sigma, phi1)


class ParametricGaussianProcess(GaussianProcess):
    def __init__(self, weights: Normal, feature_fn: Function, mean=None, device=None):
        self._weights = weights
        self._feature_fn = feature_fn
        if mean is None:
            mean = _ParametricMean(weights, feature_fn)
        super().__init__(mean=mean, cov=_ParametricCov(weights, feature_fn),
                         device=weights.mean.device if device is None else device)

    @property
    def weights(self) -> Normal:
        return self._weights

    @property
    def feature_fn(self) -> Function:
        return self._feature_fn
