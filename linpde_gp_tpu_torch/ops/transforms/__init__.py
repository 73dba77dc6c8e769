"""Operator and functional application rule engine of the port: closed
forms for the product and radial families, forward-mode autodiff for
everything else."""

from .autodiff import AutodiffTransformedKernel, DiffopFunction, apply_diffop_to_function, nested_derivative
from .dispatch import (
    apply_operator,
    apply_operator_to_function,
    apply_operator_to_kernel,
    as_coefficients,
    compose_coefficients,
)
from .functionals import apply_functional
from .product import SumOfProductsKernel, product_factor_specs, transform_product_kernel
from .radial import RadialMaternDerivativeKernel, transform_radial_kernel
from .univariate import UnivariateFactor, expquad_factor, matern_factor, wendland_factor

__all__ = [
    "apply_operator",
    "apply_operator_to_function",
    "apply_operator_to_kernel",
    "apply_functional",
    "as_coefficients",
    "compose_coefficients",
    "AutodiffTransformedKernel",
    "DiffopFunction",
    "apply_diffop_to_function",
    "nested_derivative",
    "RadialMaternDerivativeKernel",
    "transform_radial_kernel",
    "SumOfProductsKernel",
    "product_factor_specs",
    "transform_product_kernel",
    "UnivariateFactor",
    "expquad_factor",
    "matern_factor",
    "wendland_factor",
]
