"""Linear functionals of the port (evaluation functionals and their algebra)."""

from .base import (
    CompositeLinearFunctional,
    Discretization,
    LinearFunctional,
    ScaledLinearFunctional,
    SumLinearFunctional,
)
from .evaluation import DiracFunctional, _EvaluationFunctional

__all__ = [
    "LinearFunctional",
    "ScaledLinearFunctional",
    "SumLinearFunctional",
    "CompositeLinearFunctional",
    "Discretization",
    "_EvaluationFunctional",
    "DiracFunctional",
]
