"""L2 projection onto the univariate FEM hat basis.

Port of ``linpde_gp_tpu/ops/functionals/projections.py``: the load
vector ``b_i = \\int f phi_i`` by Gauss-Legendre on each element (at
``max(config.quadrature_order // 8, 8)`` nodes), the exact tridiagonal
mass matrix ``M`` and the projection coefficients ``M^{-1} b``.  The mass
matrix is numpy float64 as in the JAX package; the normalizer ``M^{-1}``
is a float64 inverse on ``config.resolve_device()``, where the nodes and
weights of the discretization live.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import config, resolve_device
from ...models.functions.fem import UnivariateLinearInterpolationBasis
from .base import Discretization, LinearFunctional
from .integrals import _gauss_legendre


class BasisIntegralFunctional(LinearFunctional):
    """``f -> [\\int f(x) phi_i(x) dx]_i``: the un-normalized load vector."""

    def __init__(self, basis: UnivariateLinearInterpolationBasis):
        self._basis = basis
        super().__init__(((), ()), basis.output_shape)

    @property
    def basis(self) -> UnivariateLinearInterpolationBasis:
        return self._basis

    @functools.cached_property
    def _disc(self) -> Discretization:
        # Gauss-Legendre on each cell of the grid: f * phi_i is a polynomial
        # times a smooth function there.
        grid = self._basis.grid
        if not self._basis.zero_boundary:
            grid = grid[1:-1]  # the sentinels carry no support
        gl_nodes, gl_weights = _gauss_legendre(max(config.quadrature_order // 8, 8))
        mid, half = 0.5 * (grid[:-1] + grid[1:]), 0.5 * (grid[1:] - grid[:-1])
        nodes = (mid[:, None] + half[:, None] * gl_nodes).reshape(-1)
        weights = (half[:, None] * gl_weights).reshape(-1)
        device = resolve_device()
        nodes = torch.tensor(nodes, dtype=torch.float64, device=device)
        phi = self._basis(nodes)  # (nq, n_basis)
        W = (phi * torch.tensor(weights, dtype=torch.float64, device=device)[:, None]).T  # (n_basis, nq)
        return Discretization(nodes, W.contiguous())

    def discretization(self) -> Discretization:
        return self._disc


def fem_mass_matrix(basis: UnivariateLinearInterpolationBasis) -> np.ndarray:
    """The exact tridiagonal P1 mass matrix (the reference's closed form)."""
    x_im1, x_i, x_ip1 = basis.x_im1, basis.x_i, basis.x_ip1
    diag = (x_ip1 - x_im1) / 3.0
    offdiag = (x_ip1[:-1] - x_i[:-1]) / 6.0
    if not basis.zero_boundary:
        diag = diag.copy()
        diag[0] = (x_ip1[0] - x_i[0]) / 3.0
        diag[-1] = (x_i[-1] - x_im1[-1]) / 3.0
    return np.diag(diag) + np.diag(offdiag, 1) + np.diag(offdiag, -1)


class L2Projection_UnivariateLinearInterpolationBasis(LinearFunctional):
    """``f -> M^{-1} [\\int f phi_i]_i``, or the load vector itself with
    ``normalized=False``."""

    def __init__(self, basis: UnivariateLinearInterpolationBasis, *, normalized: bool = True):
        self._basis = basis
        self._normalized = bool(normalized)
        self._integral = BasisIntegralFunctional(basis)
        super().__init__(((), ()), basis.output_shape)

    @property
    def basis(self) -> UnivariateLinearInterpolationBasis:
        return self._basis

    @property
    def normalized(self) -> bool:
        return self._normalized

    @functools.cached_property
    def normalizer(self) -> torch.Tensor:
        """``M^{-1}`` (the identity when not normalized), float64, on the
        default device."""
        n = len(self._basis)
        device = resolve_device()
        if not self._normalized:
            return torch.eye(n, dtype=torch.float64, device=device)
        return torch.linalg.inv(torch.tensor(fem_mass_matrix(self._basis), dtype=torch.float64, device=device))

    @functools.cached_property
    def _disc(self) -> Discretization:
        inner = self._integral.discretization()
        return Discretization(inner.points, self.normalizer.to(inner.weights) @ inner.weights)

    def discretization(self) -> Discretization:
        return self._disc

    def apply_to_function(self, f):
        disc = self._disc
        return (disc.weights @ f(disc.points)).reshape(self.output_shape)
