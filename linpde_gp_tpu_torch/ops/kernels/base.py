"""Covariance functions on torch tensors.

Port of ``linpde_gp_tpu/ops/kernels/base.py``: ``CovarianceFunction``
with broadcasting evaluation, ``pairwise`` and the Gram ``matrix`` with
the JAX package's flattening contract, scalar arithmetic and sums; and
``StationaryMixin``; ``linop``, the Gram as a linear operator (Kronecker
structure on tensor-product grids, else dense).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import as_f64
from ...utils.shapes import ShapeType, as_shape, size


class CovarianceFunction:
    """Covariance function ``k(x0, x1)`` between (possibly multi-output)
    random processes.

    ``input_shape`` is the domain shape; ``output_shape_0`` /
    ``output_shape_1`` are the codomain shapes of the two process slots.
    """

    def __init__(self, input_shape, output_shape_0=(), output_shape_1=()) -> None:
        self._input_shape: ShapeType = as_shape(input_shape)
        self._output_shape_0: ShapeType = as_shape(output_shape_0)
        self._output_shape_1: ShapeType = as_shape(output_shape_1)

    @property
    def input_shape(self) -> ShapeType:
        return self._input_shape

    @property
    def input_ndim(self) -> int:
        return len(self._input_shape)

    @property
    def input_size(self) -> int:
        return size(self._input_shape)

    @property
    def output_shape_0(self) -> ShapeType:
        return self._output_shape_0

    @property
    def output_shape_1(self) -> ShapeType:
        return self._output_shape_1

    @property
    def output_ndim_0(self) -> int:
        return len(self._output_shape_0)

    @property
    def output_ndim_1(self) -> int:
        return len(self._output_shape_1)

    @property
    def output_size_0(self) -> int:
        return size(self._output_shape_0)

    @property
    def output_size_1(self) -> int:
        return size(self._output_shape_1)

    # ------------------------------------------------------------------
    def __call__(self, x0, x1=None):
        """Broadcasting evaluation: ``x0`` of ``batch0 + input_shape``,
        ``x1`` of ``batch1 + input_shape`` (``None``: the diagonal).
        Returns ``broadcast(batch0, batch1) + output_shape_0 +
        output_shape_1``."""
        x0 = torch.as_tensor(x0)
        x1 = x0 if x1 is None else torch.as_tensor(x1)
        return self._evaluate(x0, x1)

    def _evaluate(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def pairwise(self, X0, X1):
        """``(n0,) + input`` x ``(n1,) + input`` -> ``(n0, n1) +
        output_shape_0 + output_shape_1``."""
        x0 = torch.as_tensor(X0).reshape((-1,) + self._input_shape)
        x1 = torch.as_tensor(X1).reshape((-1,) + self._input_shape)
        rest = (slice(None),) * self.input_ndim
        return self._evaluate(x0[(slice(None), None) + rest], x1[(None, slice(None)) + rest])

    def matrix(self, X0, X1=None) -> torch.Tensor:
        """Dense Gram matrix: output (codomain) dimensions come before
        batch dimensions on both axes, as in the JAX package."""
        X0 = torch.as_tensor(X0)
        X1 = X0 if X1 is None else torch.as_tensor(X1)
        n0 = size(X0.shape[: X0.ndim - self.input_ndim])
        n1 = size(X1.shape[: X1.ndim - self.input_ndim])
        gram = self.pairwise(X0, X1)  # (n0, n1) + out0 + out1
        d0, d1 = self.output_ndim_0, self.output_ndim_1
        perm = tuple(range(2, 2 + d0)) + (0,) + tuple(range(2 + d0, 2 + d0 + d1)) + (1,)
        return gram.permute(perm).reshape(self.output_size_0 * n0, self.output_size_1 * n1)

    def linop(self, X0, X1=None, device=None):
        """The Gram as a float64 linear operator: on ``TensorProductGrid``
        points with one factor per dimension, for a kernel of the
        sum-of-products family (``TensorProduct``, ``SumOfProductsKernel``
        and their scalings), the ``SumOperator`` of one ``Kronecker`` term per
        spec term of ``ops/kron_ff.kron_linop`` (``tensor_product.py:56-67``,
        ``product.py:106-138`` of the JAX package); else ``Dense(self.matrix(X0,
        X1))`` (``base.py:125``).  Numpy points land on ``device`` (``None``:
        the default device), tensors stay on theirs."""
        from ...models.domains.grid import grid_factors
        from ..gram import kernel_term_specs
        from ..kron_ff import kron_linop
        from ..linalg.linops import Dense

        f0 = grid_factors(X0)
        f1 = f0 if X1 is None else grid_factors(X1)
        if self.input_ndim == 1 and all(f is not None and len(f) == self.input_shape[0] for f in (f0, f1)):
            spec = kernel_term_specs(self)
            if spec is not None:
                return kron_linop(spec, f0, f1, device=device)
        X0 = as_f64(X0, device)
        return Dense(self.matrix(X0, None if X1 is None else as_f64(X1, device)))

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        from .arithmetic import SumCovarianceFunction

        if isinstance(other, CovarianceFunction):
            return SumCovarianceFunction(self, other)
        return NotImplemented

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            from .arithmetic import ScaledCovarianceFunction

            return ScaledCovarianceFunction(self, scalar)
        return NotImplemented

    __rmul__ = __mul__


class StationaryMixin:
    """Utilities for kernels of the form ``k(x0, x1) = phi(scaled diffs)``;
    ``lengthscales`` broadcasts over the input shape."""

    def _init_stationary(self, lengthscales) -> None:
        self.lengthscales = np.broadcast_to(np.asarray(lengthscales, dtype=np.float64), self.input_shape)

    def _diffs(self, x0, x1, scale_factors):
        d = x0 - x1
        return d * torch.as_tensor(scale_factors, dtype=d.dtype, device=d.device)

    def _squared_scaled_distances(self, x0, x1, scale_factors) -> torch.Tensor:
        diffs = self._diffs(x0, x1, scale_factors)
        if self.input_ndim == 0:
            return diffs**2
        return torch.sum(diffs**2, dim=tuple(range(-self.input_ndim, 0)))

    def _scaled_distances(self, x0, x1, scale_factors) -> torch.Tensor:
        if self.input_ndim == 0:
            return torch.abs(self._diffs(x0, x1, scale_factors))
        return torch.sqrt(self._squared_scaled_distances(x0, x1, scale_factors))
