"""Gaussian-process priors.

Port of the prior container of ``linpde_gp_tpu/models/gp.py``
(``GaussianProcess``, ``:37-80``): a mean function and a covariance
function with matching shapes.  Conditioning (the dense engine) comes
with ROADMAP Queue 1 item 9; gram-free conditioning is
``models/iterative.py``.
"""

from __future__ import annotations

from ..ops.kernels.base import CovarianceFunction
from .functions.base import Function


class GaussianProcess:
    """Prior GP ``u ~ GP(mean, cov)``."""

    def __init__(self, mean: Function, cov: CovarianceFunction):
        if mean.input_shape != cov.input_shape:
            raise ValueError("mean/cov input shapes do not match")
        if mean.output_shape != cov.output_shape_0:
            raise ValueError("mean/cov output shapes do not match")
        self._mean = mean
        self._cov = cov

    @property
    def mean(self) -> Function:
        return self._mean

    @property
    def cov(self) -> CovarianceFunction:
        return self._cov

    @property
    def input_shape(self):
        return self._cov.input_shape

    @property
    def output_shape(self):
        return self._cov.output_shape_0
