"""Covariance functions of the port: the closed-form product family, the
general-``nu`` Matérn, the multi-output and the parametric (Galerkin)
kernels."""

from .arithmetic import ScaledCovarianceFunction, SumCovarianceFunction, ZeroCovarianceFunction
from .base import CovarianceFunction, StationaryMixin
from .bessel import kv, matern_bessel
from .multioutput import IndependentMultiOutputCovarianceFunction, StackCovarianceFunction
from .parametric import GalerkinCovarianceFunction, ParametricCovarianceFunction
from .stationary import ExpQuad, Matern, half_integer_matern_coefficients
from .tensor_product import TensorProduct
from .wendland import (
    WendlandCovarianceFunction,
    WendlandFunction,
    WendlandPolynomial,
    pascal_row,
    wendland_polynomial,
)

# The grid type under the JAX package's name and location.
from ...models.domains.grid import TensorProductGrid

__all__ = [
    "CovarianceFunction",
    "StationaryMixin",
    "ScaledCovarianceFunction",
    "SumCovarianceFunction",
    "ZeroCovarianceFunction",
    "ExpQuad",
    "Matern",
    "half_integer_matern_coefficients",
    "kv",
    "matern_bessel",
    "IndependentMultiOutputCovarianceFunction",
    "StackCovarianceFunction",
    "ParametricCovarianceFunction",
    "GalerkinCovarianceFunction",
    "TensorProduct",
    "TensorProductGrid",
    "WendlandCovarianceFunction",
    "WendlandFunction",
    "WendlandPolynomial",
    "pascal_row",
    "wendland_polynomial",
]
