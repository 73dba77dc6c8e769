"""Deterministic functions of the port (``linpde_gp_tpu/models/functions``),
with the univariate FEM hat basis."""

from .arithmetic import ProductFunction, ScaledFunction, SumFunction, asfunction
from .base import Function, LambdaFunction, Zero
from .basic import (
    Affine,
    Constant,
    Piecewise,
    PiecewiseConstant,
    PiecewiseLinear,
    StackedFunction,
    TruncatedGaussianMixturePDF,
    TruncatedSineSeries,
    stack,
)
from .fem import UnivariateLinearInterpolationBasis
from .polynomial import Monomial, Polynomial, RationalPolynomial
from . import bases

__all__ = [
    "Function",
    "LambdaFunction",
    "Zero",
    "SumFunction",
    "ScaledFunction",
    "ProductFunction",
    "asfunction",
    "Constant",
    "Affine",
    "Piecewise",
    "PiecewiseLinear",
    "PiecewiseConstant",
    "TruncatedSineSeries",
    "TruncatedGaussianMixturePDF",
    "StackedFunction",
    "stack",
    "Monomial",
    "Polynomial",
    "RationalPolynomial",
    "UnivariateLinearInterpolationBasis",
    "bases",
]
