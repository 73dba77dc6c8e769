"""Univariate P1 finite-element ("hat function") basis.

Port of ``linpde_gp_tpu/models/functions/fem.py``: a multi-output
function whose components are the piecewise-linear nodal basis functions
on a 1-D grid, with the element-support queries the L2-projection and
weak-form assemblers use.  The grid tables stay numpy float64, as in the
JAX package; evaluation is in torch, on the input's device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Function


class UnivariateLinearInterpolationBasis(Function):
    def __init__(self, grid, zero_boundary: bool = False) -> None:
        grid = np.asarray(grid, dtype=np.float64)
        zero_boundary = bool(zero_boundary)
        if grid.ndim != 1 or grid.size < 3:
            raise ValueError("`grid` must be 1-D with at least 3 points.")
        if not zero_boundary:
            # Sentinel points so that the boundary hats keep unit height.
            grid = np.concatenate(([grid[0] - (grid[1] - grid[0])], grid, [grid[-1] + (grid[-1] - grid[-2])]))
        self._grid = grid
        self._zero_boundary = zero_boundary
        self._left_scale = 1.0 / (self.x_i - self.x_im1)
        self._right_scale = 1.0 / (self.x_ip1 - self.x_i)
        super().__init__((), (self._grid.size - 2,))

    @property
    def grid(self) -> np.ndarray:
        return self._grid

    @property
    def x_im1(self) -> np.ndarray:
        return self._grid[:-2]

    @property
    def x_i(self) -> np.ndarray:
        return self._grid[1:-1]

    @property
    def x_ip1(self) -> np.ndarray:
        return self._grid[2:]

    @property
    def zero_boundary(self) -> bool:
        return self._zero_boundary

    def __len__(self) -> int:
        return self.output_shape[0]

    @staticmethod
    def _hat(x, x_im1, x_i, x_ip1, left_scale, right_scale):
        return torch.clamp(
            torch.where(x < x_i, (x - x_im1) * left_scale, (x_ip1 - x) * right_scale), min=0.0
        )

    def _evaluate(self, x):
        def t(a):
            return torch.as_tensor(a, dtype=x.dtype, device=x.device)

        xe = x[..., None]
        res = self._hat(xe, t(self.x_im1), t(self.x_i), t(self.x_ip1), t(self._left_scale), t(self._right_scale))
        if not self._zero_boundary:
            # Clamp the flat extensions of the boundary hats to zero.
            res = res.clone()
            res[..., 0] = torch.where(x < self._grid[1], 0.0, res[..., 0])
            res[..., -1] = torch.where(x > self._grid[-2], 0.0, res[..., -1])
        return res

    def eval_elem(self, idx: int, x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, dtype=np.float64))
        res = self._hat(x, self.x_im1[idx], self.x_i[idx], self.x_ip1[idx], self._left_scale[idx],
                        self._right_scale[idx])
        if not self._zero_boundary:
            if idx in (0, -len(self)):
                res = torch.where(x < self._grid[1], 0.0, res)
            if idx in (len(self) - 1, -1):
                res = torch.where(x > self._grid[-2], 0.0, res)
        return res

    def support_bounds(self, idx: int):
        assert -len(self) <= idx < len(self)
        if not self._zero_boundary:
            if idx in (0, -len(self)):
                return self.x_i[0], self.x_ip1[0]
            if idx in (len(self) - 1, -1):
                return self.x_im1[-1], self.x_i[-1]
        return self.x_im1[idx], self.x_ip1[idx]

    def l2_projection(self, normalized: bool = True):
        from ...ops.functionals.projections import L2Projection_UnivariateLinearInterpolationBasis

        return L2Projection_UnivariateLinearInterpolationBasis(self, normalized=normalized)
