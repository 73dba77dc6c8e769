"""Structured linear operators on torch tensors.

Port of ``linpde_gp_tpu/ops/linalg/linops.py`` (``:32-354``): a small
tagged hierarchy of operators that densify (``todense``) and apply
(``@``), with the structured types overriding the hot paths.  Operators
hold float64 tensors (``config.as_f64``: numpy on the default device),
or a ``Dense`` the dtype it is given (the grid route's float32 Kronecker
factors in mode plain), and operands of ``@`` go to the operator's device
and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import as_f64, resolve_device

__all__ = [
    "LinearOperator",
    "Dense",
    "Identity",
    "Zero",
    "Scalar",
    "Diagonal",
    "Kronecker",
    "BlockDiagonal",
    "SumOperator",
    "Block",
    "aslinop",
]


class LinearOperator:
    """Base class: shape ``(m, n)`` linear map."""

    def __init__(self, shape, dtype=None, device=None):
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = torch.float64 if dtype is None else dtype
        self.device = resolve_device(device)

    def todense(self) -> torch.Tensor:
        raise NotImplementedError

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return Dense(self.todense() @ other.todense())
        if not isinstance(other, (np.ndarray, torch.Tensor, list, tuple, float, int)):
            return NotImplemented  # e.g. a LinearFunctional handles __rmatmul__
        return self._matmul(self._operand(other))

    def __rmatmul__(self, other):
        other = self._operand(other)
        return (self.T._matmul(other.T)).T if other.ndim == 2 else self.T._matmul(other)

    def _operand(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return as_f64(x, self.device).to(self.dtype)

    def _matmul(self, x: torch.Tensor) -> torch.Tensor:
        return self.todense() @ x

    @property
    def T(self) -> "LinearOperator":
        return Dense(self.todense().T)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return Dense(self.todense() + other.todense())
        return Dense(self.todense() + self._operand(other))

    __radd__ = __add__

    def __mul__(self, scalar):
        return Dense(self.todense() * scalar)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.todense())

    # -- the probnum-parity solve surface (``linops.py:79-94``) --------------------
    def solve(self, b) -> torch.Tensor:
        """Solve ``A x = b`` (dense LU)."""
        return torch.linalg.solve(self.todense(), self._operand(b))

    def cholesky(self, lower: bool = True) -> torch.Tensor:
        from .chol import cholesky as _chol

        chol = _chol(self.todense())
        return chol if lower else chol.T

    def inv(self) -> "LinearOperator":
        return Dense(torch.linalg.inv(self.todense()))


class Dense(LinearOperator):
    """A stored matrix: float64, or ``dtype`` if given."""

    def __init__(self, array, dtype: torch.dtype | None = None):
        if dtype is None:
            self.array = as_f64(array)
        else:
            self.array = (array if isinstance(array, torch.Tensor) else as_f64(array)).to(dtype)
        if self.array.ndim != 2:
            raise ValueError(f"a dense operator needs a matrix, got shape {tuple(self.array.shape)}")
        super().__init__(self.array.shape, self.array.dtype, self.array.device)

    def todense(self):
        return self.array

    def _matmul(self, x):
        return self.array @ x

    @property
    def T(self):
        return Dense(self.array.T, self.dtype)

    def __mul__(self, scalar):
        return Dense(self.array * scalar, self.dtype)

    __rmul__ = __mul__


class Identity(LinearOperator):
    def __init__(self, n, dtype=None, device=None):
        super().__init__((n, n), dtype, device)

    def todense(self):
        return torch.eye(self.shape[0], dtype=self.dtype, device=self.device)

    def _matmul(self, x):
        return x

    @property
    def T(self):
        return self

    def diagonal(self):
        return torch.ones((self.shape[0],), dtype=self.dtype, device=self.device)


class Zero(LinearOperator):
    def todense(self):
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    def _matmul(self, x):
        return torch.zeros(self.shape[:1] + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)

    @property
    def T(self):
        return Zero((self.shape[1], self.shape[0]), self.dtype, self.device)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return other
        return Dense(torch.broadcast_to(self._operand(other), self.shape))

    __radd__ = __add__

    def diagonal(self):
        return torch.zeros((min(self.shape),), dtype=self.dtype, device=self.device)


class Scalar(LinearOperator):
    """``alpha * I``."""

    def __init__(self, n, alpha, device=None):
        self.alpha = float(alpha)
        super().__init__((n, n), torch.float64, device)

    def todense(self):
        return self.alpha * torch.eye(self.shape[0], dtype=self.dtype, device=self.device)

    def _matmul(self, x):
        return self.alpha * x

    @property
    def T(self):
        return self

    def diagonal(self):
        return torch.full((self.shape[0],), self.alpha, dtype=self.dtype, device=self.device)


class Diagonal(LinearOperator):
    def __init__(self, diag):
        self.diag = as_f64(diag)
        super().__init__((self.diag.shape[0],) * 2, self.diag.dtype, self.diag.device)

    def todense(self):
        return torch.diag(self.diag)

    def _matmul(self, x):
        return self.diag[:, None] * x if x.ndim == 2 else self.diag * x

    @property
    def T(self):
        return self

    def diagonal(self):
        return self.diag


class Kronecker(LinearOperator):
    """``A ⊗ B``: the Gram structure of tensor-product kernels on grids."""

    def __init__(self, A: LinearOperator, B: LinearOperator):
        self.A = aslinop(A)
        self.B = aslinop(B)
        super().__init__(
            (self.A.shape[0] * self.B.shape[0], self.A.shape[1] * self.B.shape[1]), self.B.dtype, self.B.device
        )

    def todense(self):
        return torch.kron(self.A.todense(), self.B.todense())

    def _matmul(self, x):
        # (A ⊗ B) vec_C(X) with C-order flattening: X as (a_cols, b_cols).
        a_rows, b_rows = self.A.shape[0], self.B.shape[0]
        a_cols, b_cols = self.A.shape[1], self.B.shape[1]
        vector = x.ndim == 1
        if vector:
            x = x[:, None]
        xt = x.reshape(a_cols, b_cols, x.shape[1])
        xt = torch.einsum("bk,akr->abr", self.B.todense(), xt)
        out = torch.einsum("ca,abr->cbr", self.A.todense(), xt).reshape(a_rows * b_rows, -1)
        return out[:, 0] if vector else out

    @property
    def T(self):
        return Kronecker(self.A.T, self.B.T)

    def __mul__(self, scalar):
        return Kronecker(self.A * scalar, self.B)

    __rmul__ = __mul__

    def diagonal(self):
        return torch.kron(self.A.diagonal(), self.B.diagonal())


class BlockDiagonal(LinearOperator):
    def __init__(self, blocks):
        self.blocks = [aslinop(b) for b in blocks]
        m = sum(b.shape[0] for b in self.blocks)
        n = sum(b.shape[1] for b in self.blocks)
        super().__init__((m, n), self.blocks[0].dtype, self.blocks[0].device)

    def todense(self):
        return torch.block_diag(*(b.todense() for b in self.blocks))

    @property
    def T(self):
        return BlockDiagonal([b.T for b in self.blocks])

    def diagonal(self):
        return torch.cat([b.diagonal() for b in self.blocks])


class SumOperator(LinearOperator):
    """``A_1 + ... + A_m`` kept structured (e.g. sums of Kronecker products)."""

    def __init__(self, *summands: LinearOperator):
        flat = []
        for s in summands:
            if isinstance(s, SumOperator):
                flat.extend(s.summands)
            else:
                flat.append(aslinop(s))
        self.summands = flat
        super().__init__(flat[0].shape, flat[0].dtype, flat[0].device)

    def todense(self):
        out = self.summands[0].todense()
        for s in self.summands[1:]:
            out = out + s.todense()
        return out

    def _matmul(self, x):
        out = self.summands[0]._matmul(x)
        for s in self.summands[1:]:
            out = out + s._matmul(x)
        return out

    @property
    def T(self):
        return SumOperator(*(s.T for s in self.summands))

    def __mul__(self, scalar):
        return SumOperator(*(s * scalar for s in self.summands))

    __rmul__ = __mul__

    def diagonal(self):
        out = self.summands[0].diagonal()
        for s in self.summands[1:]:
            out = out + s.diagonal()
        return out


class Block(LinearOperator):
    """General block matrix from a 2-D grid of operators."""

    def __init__(self, blocks):
        self.blocks = [[aslinop(b) for b in row] for row in blocks]
        m = sum(row[0].shape[0] for row in self.blocks)
        n = sum(b.shape[1] for b in self.blocks[0])
        super().__init__((m, n), self.blocks[0][0].dtype, self.blocks[0][0].device)

    def todense(self):
        return torch.cat([torch.cat([b.todense() for b in row], dim=1) for row in self.blocks], dim=0)

    @property
    def T(self):
        return Block([[self.blocks[i][j].T for i in range(len(self.blocks))] for j in range(len(self.blocks[0]))])


def aslinop(x) -> LinearOperator:
    if isinstance(x, LinearOperator):
        return x
    arr = as_f64(x)
    if arr.ndim == 0:
        raise ValueError("Cannot convert a scalar to a linear operator.")
    if arr.ndim == 1:
        return Diagonal(arr)
    return Dense(arr)
