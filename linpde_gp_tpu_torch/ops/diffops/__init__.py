"""Linear function-operator DSL of the port."""

from .coefficients import MultiIndex, PartialDerivativeCoefficients
from .lindiffop import (
    Derivative,
    DirectionalDerivative,
    HeatOperator,
    Laplacian,
    LinearDifferentialOperator,
    PartialDerivative,
    ScaledLinearDifferentialOperator,
    SpatialLaplacian,
    TimeDerivative,
    WeightedLaplacian,
)
from .linfuncop import (
    CompositeLinearFunctionOperator,
    Identity,
    LinearFunctionOperator,
    ScaledLinearFunctionOperator,
    SelectOutput,
    SumLinearFunctionOperator,
)

__all__ = [
    "MultiIndex",
    "PartialDerivativeCoefficients",
    "LinearFunctionOperator",
    "ScaledLinearFunctionOperator",
    "SumLinearFunctionOperator",
    "CompositeLinearFunctionOperator",
    "Identity",
    "SelectOutput",
    "LinearDifferentialOperator",
    "ScaledLinearDifferentialOperator",
    "PartialDerivative",
    "Derivative",
    "TimeDerivative",
    "DirectionalDerivative",
    "WeightedLaplacian",
    "Laplacian",
    "SpatialLaplacian",
    "HeatOperator",
]
