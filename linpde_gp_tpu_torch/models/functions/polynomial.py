"""Univariate polynomials with exact rational coefficient arithmetic.

Port of ``linpde_gp_tpu/models/functions/polynomial.py`` (``Monomial``,
``Polynomial``, ``RationalPolynomial``): exact
``Fraction`` arithmetic is the host-side symbolic substrate that derives
the Matérn and Wendland closed-form kernels; evaluation is a Horner
chain on torch tensors.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Iterable, Sequence

import numpy as np
import torch

from .base import Function


def _horner(coeffs: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    res = torch.full_like(x, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        res = res * x + c
    return res


class Monomial(Function):
    """``x^degree`` over scalar inputs."""

    def __init__(self, degree: int) -> None:
        super().__init__((), ())
        degree = int(degree)
        if degree < 0:
            raise ValueError("Monomial degree must be non-negative.")
        self._degree = degree

    @property
    def degree(self) -> int:
        return self._degree

    def _evaluate(self, x):
        return x**self._degree

    def as_polynomial(self) -> "Polynomial":
        return Polynomial((0,) * self._degree + (1,))


class Polynomial(Function):
    """``p(x) = sum_k coeffs[k] x^k`` over scalar inputs."""

    def __init__(self, coeffs: Iterable) -> None:
        super().__init__((), ())
        coeffs = tuple(coeffs)
        if len(coeffs) == 0:
            coeffs = (0.0,)
        self._coeffs = tuple(float(c) for c in coeffs)

    @property
    def coefficients(self) -> tuple:
        return self._coeffs

    @property
    def degree(self) -> int:
        return len(self._coeffs) - 1

    def __repr__(self) -> str:
        return " + ".join(f"{c} * x^{k}" for k, c in enumerate(self._coeffs))

    def _evaluate(self, x):
        return _horner(self._coeffs, torch.as_tensor(x))

    def differentiate(self) -> "Polynomial":
        if self.degree == 0:
            return self._ring()([self._zero()])
        return self._ring()([c * k for k, c in enumerate(self._raw_coeffs()[1:], start=1)])

    def integrate(self) -> "Polynomial":
        return self._ring()([self._zero()] + [self._div(c, i + 1) for i, c in enumerate(self._raw_coeffs())])

    # -- exactness hooks (overridden by RationalPolynomial) ---------------
    def _ring(self):
        """Constructor for arithmetic results."""
        return RationalPolynomial if isinstance(self, RationalPolynomial) else Polynomial

    def _raw_coeffs(self):
        return self._coeffs

    @staticmethod
    def _zero():
        return 0.0

    @staticmethod
    def _one():
        return 1.0

    @staticmethod
    def _div(c, k):
        return c / k

    # -- ring arithmetic --------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Polynomial):
            a, b = self._raw_coeffs(), other._raw_coeffs()
            z = self._zero()
            n = max(len(a), len(b))
            return self._ring()(
                [(a[i] if i < len(a) else z) + (b[i] if i < len(b) else z) for i in range(n)]
            )
        if np.ndim(other) == 0:
            return self + self._ring()([other])
        return super().__add__(other)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Polynomial) or np.ndim(other) == 0:
            return self + (-1 * other if not isinstance(other, Polynomial) else -other)
        return super().__sub__(other)

    def __neg__(self):
        return self._ring()([-c for c in self._raw_coeffs()])

    def __mul__(self, other):
        if isinstance(other, Monomial):
            other = self._ring()([self._zero()] * other.degree + [self._one()])
        if isinstance(other, Polynomial):
            a, b = self._raw_coeffs(), other._raw_coeffs()
            out = [self._zero()] * (len(a) + len(b) - 1)
            for i, ai in enumerate(a):
                for j, bj in enumerate(b):
                    out[i + j] = out[i + j] + ai * bj
            return self._ring()(out)
        if np.ndim(other) == 0:
            return self._ring()([c * other for c in self._raw_coeffs()])
        return NotImplemented

    __rmul__ = __mul__


class RationalPolynomial(Polynomial):
    """Polynomial with exact ``Fraction`` coefficients; trailing zeros are
    trimmed, and ``coefficients`` holds their float values."""

    def __init__(self, coeffs: Iterable) -> None:
        coeffs = tuple(Fraction(c) for c in coeffs)
        if len(coeffs) == 0:
            coeffs = (Fraction(0),)
        while len(coeffs) > 1 and coeffs[-1] == 0:
            coeffs = coeffs[:-1]
        self._rational_coeffs = coeffs
        Function.__init__(self, (), ())
        self._coeffs = tuple(float(c) for c in coeffs)

    @property
    def rational_coefficients(self) -> tuple:
        return self._rational_coeffs

    def _raw_coeffs(self):
        return self._rational_coeffs

    @staticmethod
    def _zero():
        return Fraction(0)

    @staticmethod
    def _one():
        return Fraction(1)

    @staticmethod
    def _div(c, k):
        return Fraction(c, k) if isinstance(c, int) else c / k

    def __repr__(self) -> str:
        return " + ".join(f"{c} * x^{k}" for k, c in enumerate(self._rational_coeffs))
