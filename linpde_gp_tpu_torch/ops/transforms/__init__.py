"""Operator and functional application rule engine of the port (closed-form product route)."""

from .dispatch import (
    apply_operator,
    apply_operator_to_function,
    apply_operator_to_kernel,
    as_coefficients,
    compose_coefficients,
)
from .functionals import apply_functional
from .product import SumOfProductsKernel, product_factor_specs, transform_product_kernel
from .univariate import UnivariateFactor, expquad_factor, matern_factor, wendland_factor

__all__ = [
    "apply_operator",
    "apply_operator_to_function",
    "apply_operator_to_kernel",
    "apply_functional",
    "as_coefficients",
    "compose_coefficients",
    "SumOfProductsKernel",
    "product_factor_specs",
    "transform_product_kernel",
    "UnivariateFactor",
    "expquad_factor",
    "matern_factor",
    "wendland_factor",
]
