"""Dense and structured linear algebra of the port."""

from .chol import cho_solve, chol_extend, cholesky, logdet_from_chol, solve_triangular
from .covariance import Covariance
from .linops import (
    Block,
    BlockDiagonal,
    Dense,
    Diagonal,
    Identity,
    Kronecker,
    LinearOperator,
    Scalar,
    SumOperator,
    Zero,
    aslinop,
)

__all__ = [
    "cholesky",
    "cho_solve",
    "chol_extend",
    "solve_triangular",
    "logdet_from_chol",
    "Covariance",
    "LinearOperator",
    "Dense",
    "Identity",
    "Zero",
    "Scalar",
    "Diagonal",
    "Kronecker",
    "BlockDiagonal",
    "SumOperator",
    "Block",
    "aslinop",
]
