"""Tensor-product grids.

Port of ``linpde_gp_tpu/models/domains/grid.py`` (numpy, as there): a
``TensorProductGrid`` is the dense meshgrid array of a set of 1-D factor
grids that remembers its factors.  Kernels detect this structure and
assemble Grams as Kronecker products of small 1-D factor Grams
(``ops/kernels/tensor_product.py``, ``ops/transforms/product.py``), and
the gram-free regressor runs its matvecs on it (``ops/kron_ff.py``).

With ``indexing="ij"``, C-order flattening of the ``(n_1, ..., n_d, d)``
mesh puts point ``(i_1, ..., i_d)`` at row ``i_1 n_2 ... n_d + ... +
i_d`` (for two factors: ``t * n_x + x``): the vec convention of
``Kronecker._matmul`` and ``KronFFMatvec``.
"""

from __future__ import annotations

import numpy as np


class TensorProductGrid(np.ndarray):
    """``ndarray`` of shape ``(n_1, ..., n_d, d)`` with factor grids."""

    def __new__(cls, *factors, indexing: str = "ij"):
        factors = tuple(np.asarray(f) for f in factors)
        if not all(f.ndim == 1 for f in factors):
            raise ValueError("All grid factors must be one-dimensional.")
        mesh = np.stack(np.meshgrid(*factors, indexing=indexing), axis=-1)
        obj = mesh.view(cls)
        obj._factors = factors
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self._factors = getattr(obj, "_factors", None)

    @property
    def factors(self):
        return self._factors

    @property
    def num_factors(self) -> int:
        return len(self._factors)


def grid_factors(x) -> tuple | None:
    """The 1-D factor grids if ``x`` is a tensor-product grid, else ``None``."""
    if isinstance(x, TensorProductGrid) and x.factors is not None:
        return x.factors
    return None
