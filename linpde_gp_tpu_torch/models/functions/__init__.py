"""Functions of the port (the subset the conditioning path reads)."""

from .base import Function, Zero
from .polynomial import Polynomial, RationalPolynomial

__all__ = ["Function", "Zero", "Polynomial", "RationalPolynomial"]
