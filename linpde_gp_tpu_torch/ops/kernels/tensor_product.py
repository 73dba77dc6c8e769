"""Tensor-product kernels ``k(x0, x1) = prod_i k_i(x0_i, x1_i)``.

Port of ``linpde_gp_tpu/ops/kernels/tensor_product.py``.  On
``TensorProductGrid`` points the Gram is the Kronecker product of the
factors' 1-D Grams (``CovarianceFunction.linop``).
"""

from __future__ import annotations

from .base import CovarianceFunction


class TensorProduct(CovarianceFunction):
    r"""``k(x, y) = prod_i k_i(x_i, y_i)`` over scalar-input, scalar-output
    factor kernels.

    >>> import torch
    >>> from linpde_gp_tpu_torch.ops.kernels import Matern
    >>> kt = TensorProduct(Matern((), nu=1.5), Matern((), nu=2.5))
    >>> kt.input_shape
    (2,)
    >>> round(float(kt(torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64))), 6)
    0.253277
    """

    def __init__(self, *factors: CovarianceFunction):
        factors = tuple(factors)
        if not all(f.input_shape == () for f in factors):
            raise ValueError("TensorProduct factors must be scalar-input kernels.")
        if not all(f.output_shape_0 == () and f.output_shape_1 == () for f in factors):
            raise ValueError("TensorProduct factors must be scalar-output kernels.")
        self._factors = factors
        super().__init__((len(factors),))

    @property
    def factors(self):
        return self._factors

    def _evaluate(self, x0, x1):
        out = None
        for i, k in enumerate(self._factors):
            term = k._evaluate(x0[..., i], x1[..., i])
            out = term if out is None else out * term
        return out
