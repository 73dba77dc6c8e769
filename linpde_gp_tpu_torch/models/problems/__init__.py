"""PDE problems (port of ``linpde_gp_tpu/models/problems``)."""

from .pde import (
    BoundaryCondition,
    BoundaryValueProblem,
    DirichletBoundaryCondition,
    HeatEquation,
    HeatEquationDirichletProblem,
    InitialBoundaryValueProblem,
    LinearPDE,
    PoissonEquation,
    PoissonEquationDirichletProblem,
    Solution_HeatEquation_DirichletProblem_1D_InitialTruncatedSineSeries_BoundaryZero,
    Solution_PoissonEquation_DirichletProblem_1D_RHSConstant,
    Solution_PoissonEquation_IVP_1D_RHSPolynomial,
    Solution_PoissonEquation_IVP_1D_RHSPiecewisePolynomial,
    get_1d_dirichlet_boundary_observations,
)

pde = __import__(__name__ + ".pde", fromlist=["pde"])

__all__ = [
    "LinearPDE",
    "BoundaryCondition",
    "DirichletBoundaryCondition",
    "BoundaryValueProblem",
    "InitialBoundaryValueProblem",
    "PoissonEquation",
    "PoissonEquationDirichletProblem",
    "HeatEquation",
    "HeatEquationDirichletProblem",
    "Solution_PoissonEquation_DirichletProblem_1D_RHSConstant",
    "Solution_PoissonEquation_IVP_1D_RHSPolynomial",
    "Solution_PoissonEquation_IVP_1D_RHSPiecewisePolynomial",
    "Solution_HeatEquation_DirichletProblem_1D_InitialTruncatedSineSeries_BoundaryZero",
    "get_1d_dirichlet_boundary_observations",
    "pde",
]
