"""Kernels, operators, functionals, cross-covariances, linear algebra and
the rule engine of the port."""

from . import crosscov, diffops, functionals, kernels, linalg, transforms

__all__ = ["crosscov", "diffops", "functionals", "kernels", "linalg", "transforms"]
