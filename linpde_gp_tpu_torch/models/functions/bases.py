"""Namespace mirroring the reference's ``linpde_gp.functions.bases``."""

from .fem import UnivariateLinearInterpolationBasis

__all__ = ["UnivariateLinearInterpolationBasis"]
