"""Weak-form functionals (FEM stiffness assembly).

Port of ``linpde_gp_tpu/ops/functionals/weak_forms.py``:
``WeakForm_Laplacian_UnivariateInterpolationBasis`` applied to a trial hat
basis gives the tridiagonal stiffness matrix (a ``linops.Dense``); applied
to any other function it is ``f -> [\\int phi_i Laplace f]_i``.
"""

from __future__ import annotations

import numpy as np

from ...models.functions.fem import UnivariateLinearInterpolationBasis
from ..diffops.lindiffop import Laplacian
from .base import CompositeLinearFunctional
from .projections import BasisIntegralFunctional


class WeakForm_Laplacian_UnivariateInterpolationBasis(CompositeLinearFunctional):
    def __init__(self, test_basis: UnivariateLinearInterpolationBasis):
        assert test_basis.zero_boundary
        self._test_basis = test_basis
        super().__init__(None, BasisIntegralFunctional(test_basis), Laplacian(()))

    @property
    def test_basis(self) -> UnivariateLinearInterpolationBasis:
        return self._test_basis

    def stiffness_matrix(self, trial_basis: UnivariateLinearInterpolationBasis):
        """The exact P1 stiffness matrix ``A[i, j] = \\int phi_i Laplace psi_j
        = -\\int phi_i' psi_j'`` of a trial basis with free boundary hats on
        the same interior grid."""
        from ..linalg.linops import Dense

        if trial_basis.zero_boundary:
            raise NotImplementedError("trial basis must include boundary hats")
        if not (
            len(trial_basis) == len(self._test_basis) + 2 and np.all(trial_basis.grid[1:-1] == self._test_basis.grid)
        ):
            raise NotImplementedError("trial/test grids do not match")
        inv_h = 1.0 / np.diff(trial_basis.grid)
        n_test = len(self._test_basis)
        A = np.zeros((n_test, len(trial_basis)))
        rows = np.arange(n_test)
        A[rows, rows] = inv_h[:n_test]
        A[rows, rows + 1] = -inv_h[:n_test] - inv_h[1:n_test + 1]
        A[rows, rows + 2] = inv_h[1:n_test + 1]
        return Dense(A)
