"""Deterministic functions of the port (``linpde_gp_tpu/models/functions``
without the FEM bases, which are ROADMAP Queue 1 item 9c)."""

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
from .polynomial import Monomial, Polynomial, RationalPolynomial

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
]
