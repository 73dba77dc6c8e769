"""Covariance "views": the tensor and matrix forms of a covariance between
two multi-dimensional quantities.

Port of ``linpde_gp_tpu/ops/linalg/covariance.py`` (``Covariance``,
``:17``): a covariance with ``shape0`` / ``shape1`` is an array of shape
``shape0 + shape1`` or its C-order flattened matrix.  The port adds a
diagonal form (:meth:`Covariance.from_diagonal`, what ``Normal`` makes of
a 1-D covariance): its matrix is formed only when asked for, and
:meth:`Covariance.add_to_` adds it into a Gram in place, so observation
noise ``sigma^2 I`` at n = 32,768 costs n numbers, not 8.6 GB.
"""

from __future__ import annotations

import torch

from ...config import as_f64
from ...utils.shapes import ShapeType, as_shape, size


class Covariance:
    """Dense (or diagonal) covariance block with tensor and matrix views."""

    def __init__(self, array, shape0, shape1) -> None:
        self._shape0: ShapeType = as_shape(shape0)
        self._shape1: ShapeType = as_shape(shape1)
        self._diag = None
        array = array if isinstance(array, torch.Tensor) else as_f64(array)
        expected = self._shape0 + self._shape1
        if tuple(array.shape) == expected:
            self._array = array
        elif tuple(array.shape) == (size(self._shape0), size(self._shape1)):
            self._array = array.reshape(expected)
        else:
            raise ValueError(
                f"Covariance array of shape {tuple(array.shape)} does not match "
                f"shape0={self._shape0}, shape1={self._shape1}."
            )

    @classmethod
    def from_diagonal(cls, diag, shape) -> "Covariance":
        """The diagonal covariance of a quantity of ``shape`` with the
        variances ``diag`` (``size(shape)`` numbers)."""
        self = cls.__new__(cls)
        self._shape0 = self._shape1 = as_shape(shape)
        self._array = None
        self._diag = (diag if isinstance(diag, torch.Tensor) else as_f64(diag)).reshape(-1)
        if self._diag.shape[0] != size(self._shape0):
            raise ValueError(f"{self._diag.shape[0]} variances for a quantity of shape {self._shape0}")
        return self

    @property
    def shape0(self) -> ShapeType:
        return self._shape0

    @property
    def shape1(self) -> ShapeType:
        return self._shape1

    @property
    def size0(self) -> int:
        return size(self._shape0)

    @property
    def size1(self) -> int:
        return size(self._shape1)

    @property
    def array(self) -> torch.Tensor:
        """Tensor view of shape ``shape0 + shape1``."""
        if self._diag is not None:
            return torch.diag(self._diag).reshape(self._shape0 + self._shape1)
        return self._array

    @property
    def matrix(self) -> torch.Tensor:
        """Flattened 2-D view (C-order)."""
        return self.array.reshape(self.size0, self.size1)

    def diagonal(self) -> torch.Tensor:
        """The ``min(size0, size1)`` diagonal entries of :attr:`matrix`."""
        return self._diag if self._diag is not None else torch.diagonal(self.matrix)

    def add_to_(self, gram: torch.Tensor) -> torch.Tensor:
        """``gram += matrix`` in place (the diagonal form touches only the
        diagonal); returns ``gram``."""
        if self._diag is not None:
            gram.diagonal().add_(self._diag.to(gram))
        else:
            gram.add_(self.matrix.to(gram))
        return gram

    @property
    def linop(self):
        """Structured-operator view."""
        from .linops import Dense, Diagonal

        return Diagonal(self._diag) if self._diag is not None else Dense(self.matrix)

    @property
    def T(self) -> "Covariance":
        if self._diag is not None:
            return self
        mat = self.matrix.T.reshape(self._shape1 + self._shape0)
        return Covariance(mat, self._shape1, self._shape0)

    def __add__(self, other):
        if isinstance(other, Covariance):
            if self._diag is not None and other._diag is not None:
                return Covariance.from_diagonal(self._diag + other._diag, self._shape0)
            other = other.array
        return Covariance(self.array + torch.as_tensor(other).to(self.array), self._shape0, self._shape1)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-other if isinstance(other, Covariance) else -torch.as_tensor(other))

    def __mul__(self, scalar):
        if self._diag is not None:
            return Covariance.from_diagonal(self._diag * scalar, self._shape0)
        return Covariance(self._array * scalar, self._shape0, self._shape1)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)
