"""Linear PDE problems: Poisson and heat equations with Dirichlet data,
and the closed-form solutions that serve as oracles.

Port of ``linpde_gp_tpu/models/problems/pde.py``.  The problems are data
(domains, operators, functions); the solutions evaluate on torch tensors,
on the input's device and dtype.  Conditioning a prior on a problem's
right-hand side goes through the operator layer, which applies the
problem's operator to any prior mean (``ops/transforms/dispatch.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ...ops.diffops import (
    HeatOperator,
    Identity,
    Laplacian,
    LinearFunctionOperator,
)
from ..domains import CartesianProduct, Domain, Interval, Point, asdomain
from ..functions import (
    Constant,
    Function,
    Piecewise,
    Polynomial,
    TruncatedSineSeries,
    Zero,
)


class LinearPDE:
    """``D u = f`` on a domain."""

    def __init__(self, domain, diffop, rhs: Function | None = None):
        self._domain = asdomain(domain)
        if diffop.input_domain_shape != self._domain.shape:
            raise ValueError(
                f"diffop domain shape {diffop.input_domain_shape} != "
                f"domain shape {self._domain.shape}"
            )
        self._diffop = diffop
        if rhs is None:
            rhs = Zero(self._domain.shape, diffop.output_codomain_shape)
        if rhs.input_shape != self._domain.shape:
            raise ValueError("rhs input shape does not match the domain")
        self._rhs = rhs

    @property
    def domain(self) -> Domain:
        return self._domain

    @property
    def diffop(self):
        return self._diffop

    @property
    def rhs(self) -> Function:
        return self._rhs


class BoundaryCondition:
    def __init__(self, boundary, operator: LinearFunctionOperator, values):
        self._boundary = asdomain(boundary)
        if operator.input_domain_shape != self._boundary.shape:
            raise ValueError("boundary operator domain mismatch")
        self._operator = operator
        if not isinstance(values, Function):
            values = Constant(operator.output_domain_shape, values)
        self._values = values

    @property
    def boundary(self) -> Domain:
        return self._boundary

    @property
    def operator(self) -> LinearFunctionOperator:
        return self._operator

    @property
    def values(self) -> Function:
        return self._values


class DirichletBoundaryCondition(BoundaryCondition):
    def __init__(self, boundary, values):
        boundary = asdomain(boundary)
        out_shape = (
            values.output_shape if isinstance(values, Function) else np.shape(values)
        )
        super().__init__(
            boundary=boundary,
            operator=Identity(boundary.shape, out_shape),
            values=values,
        )


def get_1d_dirichlet_boundary_observations(
    dirichlet_bcs: Sequence[DirichletBoundaryCondition],
):
    """Reference: ``problems/pde/_bvp.py:75-88``."""
    if len(dirichlet_bcs) != 2 or not all(
        isinstance(bc.boundary, Point) for bc in dirichlet_bcs
    ):
        raise ValueError("expected the two endpoint boundary conditions")
    X_bc = np.asarray([float(bc.boundary) for bc in dirichlet_bcs])
    Y_bc = np.asarray(
        [float(bc.values(torch.tensor(x, dtype=torch.float64))) for bc, x in zip(dirichlet_bcs, X_bc)]
    )
    return X_bc, Y_bc


@dataclasses.dataclass(frozen=True)
class BoundaryValueProblem:
    pde: LinearPDE
    boundary_conditions: Sequence[BoundaryCondition]
    solution: Function | None = None

    @property
    def domain(self):
        return self.pde.domain


class InitialBoundaryValueProblem(BoundaryValueProblem):
    def __init__(self, pde, initial_condition, boundary_conditions, solution=None):
        if (
            not isinstance(pde.domain, CartesianProduct)
            or len(pde.domain) != 2
            or not isinstance(pde.domain[0], Interval)
        ):
            raise ValueError("expected a (time x space) product domain")
        self._initial_condition = initial_condition
        object.__setattr__(self, "pde", pde)
        object.__setattr__(self, "boundary_conditions", tuple(boundary_conditions))
        object.__setattr__(self, "solution", solution)

    @property
    def temporal_domain(self) -> Interval:
        return self.domain[0]

    @property
    def t0(self) -> float:
        return float(self.temporal_domain[0])

    @property
    def T(self) -> float:
        return float(self.temporal_domain[1])

    @property
    def spatial_domain(self) -> Domain:
        return self.domain[1]

    @functools.cached_property
    def initial_domain(self) -> CartesianProduct:
        return CartesianProduct(Point(self.t0), self.spatial_domain)

    @property
    def initial_condition(self) -> DirichletBoundaryCondition:
        return self._initial_condition


# ---------------------------------------------------------------------------
# Poisson
# ---------------------------------------------------------------------------
class PoissonEquation(LinearPDE):
    """``-alpha Δu = f`` (reference: ``_poisson.py:14``)."""

    def __init__(self, domain, rhs=None, alpha: float = 1.0):
        domain = asdomain(domain)
        super().__init__(
            domain=domain,
            diffop=-alpha * Laplacian(domain_shape=domain.shape),
            rhs=rhs,
        )
        self._alpha = float(alpha)

    @property
    def alpha(self) -> float:
        return self._alpha


class PoissonEquationDirichletProblem(BoundaryValueProblem):
    """Reference: ``_poisson.py:36``."""

    def __init__(
        self,
        domain,
        *,
        rhs=None,
        alpha: float = 1.0,
        boundary_values=None,
        solution=None,
    ):
        pde = PoissonEquation(domain, rhs=rhs, alpha=alpha)

        if boundary_values is None:
            boundary_values = Zero(pde.domain.shape, ())

        if pde.domain.shape == ():
            if not isinstance(pde.domain, Interval):
                raise TypeError("scalar case requires an Interval domain")
            if isinstance(boundary_values, Function):
                a, b = pde.domain
                boundary_values = (
                    float(boundary_values(torch.tensor(float(a), dtype=torch.float64))),
                    float(boundary_values(torch.tensor(float(b), dtype=torch.float64))),
                )
            boundary_values = np.asarray(boundary_values)
            if solution is None and isinstance(pde.rhs, Constant):
                solution = Solution_PoissonEquation_DirichletProblem_1D_RHSConstant(
                    pde.domain,
                    rhs=float(pde.rhs.value),
                    boundary_values=boundary_values,
                    alpha=pde.alpha,
                )

        if isinstance(boundary_values, Function):
            boundary_conditions = tuple(
                DirichletBoundaryCondition(part, boundary_values)
                for part in pde.domain.boundary
            )
        else:
            boundary_values = np.asarray(boundary_values)
            boundary_conditions = tuple(
                DirichletBoundaryCondition(part, value)
                for part, value in zip(pde.domain.boundary, boundary_values)
            )

        super().__init__(
            pde=pde, boundary_conditions=boundary_conditions, solution=solution
        )


class Solution_PoissonEquation_DirichletProblem_1D_RHSConstant(Function):
    """Exact quadratic solution of ``-alpha u'' = c`` with Dirichlet data
    (reference: ``_poisson.py:98``)."""

    def __init__(self, domain, rhs, boundary_values, alpha: float = 1.0):
        super().__init__((), ())
        domain = asdomain(domain)
        if not isinstance(domain, Interval):
            raise TypeError("Interval domains only")
        self._l, self._r = float(domain[0]), float(domain[1])
        self._rhs = float(rhs)
        bv = np.asarray(boundary_values)
        self._u_l, self._u_r = float(bv[0]), float(bv[1])
        self._alpha = float(alpha)
        self._coeffs = [
            self._u_l,
            (self._u_r - self._u_l) / (self._r - self._l),
            0.5 * self._rhs / -self._alpha,
        ]

    def _evaluate(self, x):
        a = self._coeffs
        return (a[2] * (x - self._r) + a[1]) * (x - self._l) + a[0]


class Solution_PoissonEquation_IVP_1D_RHSPolynomial(Polynomial):
    """Exact polynomial solution of the 1-D Poisson IVP (reference:
    ``_poisson.py:137``)."""

    def __init__(self, domain, rhs: Polynomial, initial_values, alpha):
        domain = asdomain(domain)
        if not isinstance(domain, Interval):
            raise TypeError("Interval domains only")
        self._l, self._r = float(domain[0]), float(domain[1])
        if not isinstance(rhs, Polynomial):
            raise TypeError("rhs must be a Polynomial")
        initial_values = np.asarray(initial_values, dtype=np.float64)
        alpha = float(alpha)

        rhs_int = rhs.integrate()
        rhs_dblint = rhs_int.integrate()

        coeff_1 = float(initial_values[1]) - float(
            rhs_int(torch.tensor(self._l, dtype=torch.float64))
        ) / -alpha
        coeff_0 = (
            float(initial_values[0])
            - self._l * coeff_1
            - float(rhs_dblint(torch.tensor(self._l, dtype=torch.float64))) / -alpha
        )
        super().__init__(
            (coeff_0, coeff_1)
            + tuple(c / -alpha for c in rhs_dblint.coefficients[2:])
        )


class Solution_PoissonEquation_IVP_1D_RHSPiecewisePolynomial(Piecewise):
    """Reference: ``_poisson.py:175``."""

    def __init__(self, domain, rhs: Piecewise, initial_values, alpha):
        domain = asdomain(domain)
        if not isinstance(domain, Interval):
            raise TypeError("Interval domains only")
        if not all(isinstance(p, Polynomial) for p in rhs.pieces):
            raise TypeError("rhs must be piecewise polynomial")
        alpha = float(alpha)
        sol_pieces = []
        piece_iv = np.asarray(initial_values, dtype=np.float64)
        for rhs_piece, lo, hi in zip(rhs.pieces, rhs.xs[:-1], rhs.xs[1:]):
            sol = Solution_PoissonEquation_IVP_1D_RHSPolynomial(
                (lo, hi), rhs=rhs_piece, initial_values=piece_iv, alpha=alpha
            )
            sol_pieces.append(sol)
            piece_iv = np.asarray(
                [
                    float(sol(torch.tensor(float(hi), dtype=torch.float64))),
                    float(sol.differentiate()(torch.tensor(float(hi), dtype=torch.float64))),
                ]
            )
        super().__init__(xs=rhs.xs, fns=sol_pieces)


# ---------------------------------------------------------------------------
# Heat
# ---------------------------------------------------------------------------
class HeatEquation(LinearPDE):
    """``∂_t u - alpha Δ_x u = f`` (reference: ``_heat.py:16``)."""

    def __init__(self, domain, rhs=None, alpha: float = 1.0):
        self._alpha = float(alpha)
        domain = asdomain(domain)
        super().__init__(
            domain=domain,
            diffop=HeatOperator(domain_shape=domain.shape, alpha=self._alpha),
            rhs=rhs,
        )

    @property
    def alpha(self) -> float:
        return self._alpha


class HeatEquationDirichletProblem(InitialBoundaryValueProblem):
    """Reference: ``_heat.py:32``."""

    def __init__(
        self,
        t0,
        spatial_domain,
        T=float("inf"),
        rhs=None,
        alpha: float = 1.0,
        initial_values=None,
        solution=None,
    ):
        spatial_domain = asdomain(spatial_domain)
        domain = CartesianProduct(Interval(t0, T), spatial_domain)
        pde = HeatEquation(domain, rhs=rhs, alpha=alpha)

        if initial_values is None:
            initial_values = Zero(spatial_domain.shape, ())

        initial_condition = DirichletBoundaryCondition(
            domain[1], initial_values
        )

        boundary_conditions = tuple(
            DirichletBoundaryCondition(
                CartesianProduct(domain[0], boundary_part), np.zeros(())
            )
            for boundary_part in domain[1].boundary
        )

        if solution is None:
            if isinstance(initial_values, Zero):
                solution = Zero(domain.shape, ())
            elif isinstance(domain[1], Interval) and isinstance(
                initial_values, TruncatedSineSeries
            ):
                if initial_values.domain == domain[1]:
                    solution = Solution_HeatEquation_DirichletProblem_1D_InitialTruncatedSineSeries_BoundaryZero(
                        t0=t0,
                        spatial_domain=spatial_domain,
                        initial_values=initial_values,
                        alpha=alpha,
                    )

        super().__init__(
            pde=pde,
            initial_condition=initial_condition,
            boundary_conditions=boundary_conditions,
            solution=solution,
        )


class Solution_HeatEquation_DirichletProblem_1D_InitialTruncatedSineSeries_BoundaryZero(
    Function
):
    """Separation-of-variables sine-series solution (reference:
    ``_heat.py:96``)."""

    def __init__(self, t0, spatial_domain, initial_values, alpha):
        self._t0 = float(t0)
        self._spatial_domain = asdomain(spatial_domain)
        if not isinstance(self._spatial_domain, Interval):
            raise TypeError("Interval spatial domains only")
        self._initial_values = initial_values
        self._alpha = float(alpha)
        if self._spatial_domain != initial_values.domain:
            raise ValueError("the initial values must live on the spatial domain")
        super().__init__((2,), ())

    @functools.cached_property
    def _decay_rates(self) -> np.ndarray:
        return self._alpha * self._initial_values.half_angular_frequencies**2

    def _evaluate(self, txs):
        l = float(self._spatial_domain[0])  # noqa: E741
        ts = txs[..., 0:1]
        xs = txs[..., 1:2]

        def like(a):
            return torch.as_tensor(np.array(a, dtype=np.float64), dtype=txs.dtype, device=txs.device)

        return torch.sum(
            like(self._initial_values.coefficients)
            * torch.sin(like(self._initial_values.half_angular_frequencies) * (xs - l))
            * torch.exp(like(self._decay_rates) * (self._t0 - ts)),
            dim=-1,
        )
