"""Linear functionals of the port: evaluation, Lebesgue integrals, FEM
projections and weak forms, and their algebra."""

from .base import (
    CompositeLinearFunctional,
    Discretization,
    LinearFunctional,
    ScaledLinearFunctional,
    SumLinearFunctional,
)
from .evaluation import DiracFunctional, _EvaluationFunctional
from .integrals import LebesgueIntegral, interval_quadrature
from .projections import (
    BasisIntegralFunctional,
    L2Projection_UnivariateLinearInterpolationBasis,
    fem_mass_matrix,
)
from .weak_forms import WeakForm_Laplacian_UnivariateInterpolationBasis
from . import projections_ns as projections
from . import weak_forms

__all__ = [
    "LinearFunctional",
    "ScaledLinearFunctional",
    "SumLinearFunctional",
    "CompositeLinearFunctional",
    "Discretization",
    "_EvaluationFunctional",
    "DiracFunctional",
    "LebesgueIntegral",
    "interval_quadrature",
    "BasisIntegralFunctional",
    "L2Projection_UnivariateLinearInterpolationBasis",
    "fem_mass_matrix",
    "WeakForm_Laplacian_UnivariateInterpolationBasis",
    "projections",
    "weak_forms",
]
