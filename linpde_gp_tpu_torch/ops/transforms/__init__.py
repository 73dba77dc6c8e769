"""Operator application rule engine of the port (closed-form product route)."""

from .dispatch import apply_operator, apply_operator_to_kernel, as_coefficients, compose_coefficients
from .product import SumOfProductsKernel, product_factor_specs, transform_product_kernel
from .univariate import UnivariateFactor, expquad_factor, matern_factor, wendland_factor

__all__ = [
    "apply_operator",
    "apply_operator_to_kernel",
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
