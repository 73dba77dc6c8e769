"""Kernel arithmetic: scaled, summed and zero covariance functions
(port of ``linpde_gp_tpu/ops/kernels/arithmetic.py``), with their Grams as
linear operators (``linop``)."""

from __future__ import annotations

import numpy as np
import torch

from ...config import as_f64
from ...utils.shapes import size
from .base import CovarianceFunction


class ScaledCovarianceFunction(CovarianceFunction):
    def __init__(self, covfunc: CovarianceFunction, scalar):
        if np.ndim(scalar) != 0:
            raise ValueError("scalar must be 0-dimensional")
        if isinstance(covfunc, ScaledCovarianceFunction):
            scalar = scalar * covfunc.scalar
            covfunc = covfunc.covfunc
        self._covfunc = covfunc
        self._scalar = float(scalar)
        super().__init__(covfunc.input_shape, covfunc.output_shape_0, covfunc.output_shape_1)

    @property
    def covfunc(self) -> CovarianceFunction:
        return self._covfunc

    @property
    def scalar(self) -> float:
        return self._scalar

    def _evaluate(self, x0, x1):
        return self._scalar * self._covfunc._evaluate(x0, x1)

    def matrix(self, X0, X1=None):
        return self._scalar * self._covfunc.matrix(X0, X1)

    def linop(self, X0, X1=None, device=None):
        return self._covfunc.linop(X0, X1, device) * self._scalar


class SumCovarianceFunction(CovarianceFunction):
    def __init__(self, *summands: CovarianceFunction):
        flat = []
        for s in summands:
            if isinstance(s, SumCovarianceFunction):
                flat.extend(s.summands)
            else:
                flat.append(s)
        self._summands = tuple(flat)
        first = flat[0]
        for s in flat[1:]:
            if (
                s.input_shape != first.input_shape
                or s.output_shape_0 != first.output_shape_0
                or s.output_shape_1 != first.output_shape_1
            ):
                raise ValueError("Summand shapes do not match.")
        super().__init__(first.input_shape, first.output_shape_0, first.output_shape_1)

    @property
    def summands(self):
        return self._summands

    def _evaluate(self, x0, x1):
        out = self._summands[0]._evaluate(x0, x1)
        for s in self._summands[1:]:
            out = out + s._evaluate(x0, x1)
        return out

    def matrix(self, X0, X1=None):
        out = self._summands[0].matrix(X0, X1)
        for s in self._summands[1:]:
            out = out + s.matrix(X0, X1)
        return out

    def linop(self, X0, X1=None, device=None):
        """The ``SumOperator`` of the summands' operators, structured where
        they are (the JAX package gives the dense Gram of every sum)."""
        from ..linalg.linops import SumOperator

        return SumOperator(*(s.linop(X0, X1, device) for s in self._summands))


class ZeroCovarianceFunction(CovarianceFunction):
    """The zero kernel."""

    def _evaluate(self, x0, x1):
        batch = torch.broadcast_shapes(
            x0.shape[: x0.ndim - self.input_ndim], x1.shape[: x1.ndim - self.input_ndim]
        )
        return torch.zeros(
            tuple(batch) + self.output_shape_0 + self.output_shape_1, dtype=x0.dtype, device=x0.device
        )

    def linop(self, X0, X1=None, device=None):
        from ..linalg.linops import Zero as ZeroOp

        X0 = as_f64(X0, device)
        X1 = X0 if X1 is None else as_f64(X1, device)
        n0 = size(X0.shape[: X0.ndim - self.input_ndim]) * self.output_size_0
        n1 = size(X1.shape[: X1.ndim - self.input_ndim]) * self.output_size_1
        return ZeroOp((n0, n1), torch.float64, X0.device)
