"""Namespace mirroring ``linpde_gp.linfunctls.projections.l2``."""

from ..projections import (
    BasisIntegralFunctional,
    L2Projection_UnivariateLinearInterpolationBasis,
    fem_mass_matrix,
)

__all__ = [
    "L2Projection_UnivariateLinearInterpolationBasis",
    "BasisIntegralFunctional",
    "fem_mass_matrix",
]
