"""Multi-output covariance functions.

Port of ``linpde_gp_tpu/ops/kernels/multioutput.py``:
``IndependentMultiOutputCovarianceFunction`` (``k[i, j] = delta_ij k_i``,
the block-diagonal prior of multi-field models such as the CPU thermal
case study's ``(u, q_V, q_A)``) and ``StackCovarianceFunction`` (scalar
kernels stacked along one output slot).  Their Grams use the output-first
flattening of ``CovarianceFunction.matrix``.
"""

from __future__ import annotations

import torch

from .base import CovarianceFunction


def _check_scalar(covfuncs, what: str):
    input_shape = covfuncs[0].input_shape
    if not all(
        k.input_shape == input_shape and k.output_shape_0 == () and k.output_shape_1 == () for k in covfuncs
    ):
        raise ValueError(f"All {what} kernels must be scalar-output with a common input shape.")
    return input_shape


class IndependentMultiOutputCovarianceFunction(CovarianceFunction):
    """Diagonal multi-output kernel: ``k[i, j] = delta_ij k_i``."""

    def __init__(self, *covfuncs: CovarianceFunction):
        self._covfuncs = tuple(covfuncs)
        m = len(self._covfuncs)
        super().__init__(_check_scalar(self._covfuncs, "component"), (m,), (m,))

    @property
    def covfuncs(self):
        return self._covfuncs

    def _evaluate(self, x0, x1):
        # diag_embed, not an in-place write: the autodiff route differentiates it.
        return torch.diag_embed(torch.stack([k._evaluate(x0, x1) for k in self._covfuncs], dim=-1))

    def matrix(self, X0, X1=None):
        """The block-diagonal Gram (output dimensions first)."""
        return torch.block_diag(*(k.matrix(X0, X1) for k in self._covfuncs))

    def linop(self, X0, X1=None, device=None):
        from ..linalg.linops import BlockDiagonal

        return BlockDiagonal([k.linop(X0, X1, device=device) for k in self._covfuncs])


class StackCovarianceFunction(CovarianceFunction):
    """Scalar-output kernels stacked along the output slot ``stack_argnum``."""

    def __init__(self, *covfuncs: CovarianceFunction, stack_argnum: int = 0):
        self._covfuncs = tuple(covfuncs)
        self._stack_argnum = stack_argnum
        m = len(self._covfuncs)
        super().__init__(
            _check_scalar(self._covfuncs, "stacked"),
            (m,) if stack_argnum == 0 else (),
            (m,) if stack_argnum == 1 else (),
        )

    @property
    def covfuncs(self):
        return self._covfuncs

    @property
    def stack_argnum(self) -> int:
        return self._stack_argnum

    def _evaluate(self, x0, x1):
        vals = [k._evaluate(x0, x1) for k in self._covfuncs]
        shape = torch.broadcast_shapes(*(v.shape for v in vals))
        return torch.stack([v.expand(shape) for v in vals], dim=-1)

    def matrix(self, X0, X1=None):
        return torch.cat([k.matrix(X0, X1) for k in self._covfuncs], dim=self._stack_argnum)
