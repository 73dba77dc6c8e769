"""Process-vector cross-covariances of the port."""

from .base import (
    ConcatenatedCrossCovariance,
    KernelFunctionalCrossCov,
    LinOpProcessVectorCrossCovariance,
    ProcessVectorCrossCovariance,
    ScaledProcessVectorCrossCovariance,
    SumProcessVectorCrossCovariance,
    ZeroProcessVectorCrossCovariance,
    apply_functional_to_crosscov,
    evaluate_crosscov_contraction,
)

__all__ = [
    "ProcessVectorCrossCovariance",
    "KernelFunctionalCrossCov",
    "ScaledProcessVectorCrossCovariance",
    "SumProcessVectorCrossCovariance",
    "LinOpProcessVectorCrossCovariance",
    "ZeroProcessVectorCrossCovariance",
    "ConcatenatedCrossCovariance",
    "apply_functional_to_crosscov",
    "evaluate_crosscov_contraction",
]
