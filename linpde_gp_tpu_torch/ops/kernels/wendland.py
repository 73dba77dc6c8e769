r"""Wendland compactly supported covariance functions.

Port of ``linpde_gp_tpu/ops/kernels/wendland.py``.  Construction
(Wendland, *Scattered Data Approximation*, Thm. 9.12/9.13), with exact
rationals:

    phi_{l,0}(r) = (1 - r)_+^l,           l = floor(d/2) + k + 1
    phi_{d,k}    = I^k phi_{l,0},         (I f)(r) = int_r^1 t f(t) dt

normalized so that ``phi(0) = 1``.  If ``Q`` is the antiderivative of
``t p(t)`` then ``(I p)(r) = Q(1) - Q(r)``.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from ...models.functions.base import Function
from ...models.functions.polynomial import RationalPolynomial
from .base import CovarianceFunction, StationaryMixin


def pascal_row(n: int) -> list[int]:
    """Binomial coefficients of ``(a + b)^n``."""
    row = [1]
    for i in range(n):
        row.append(row[-1] * (n - i) // (i + 1))
    return row


@functools.lru_cache(maxsize=None)
def wendland_polynomial(d: int, k: int) -> RationalPolynomial:
    """The exact polynomial part ``p_{d,k}`` of ``phi_{d,k}`` on ``[0, 1]``."""
    l = d // 2 + k + 1  # noqa: E741 - Wendland's name
    coeffs = [Fraction((-1) ** j * c) for j, c in enumerate(pascal_row(l))]
    poly = RationalPolynomial(coeffs)
    for _ in range(k):
        tp = RationalPolynomial([Fraction(0), Fraction(1)]) * poly
        q = tp.integrate()
        q1 = sum(q.rational_coefficients, Fraction(0))
        poly = RationalPolynomial([q1]) - q
    c0 = poly.rational_coefficients[0]
    return poly * (Fraction(1) / c0)


class WendlandPolynomial(RationalPolynomial):
    """Polynomial part ``p_{d,k}`` of the Wendland function."""

    def __init__(self, d: int, k: int):
        super().__init__(wendland_polynomial(int(d), int(k)).rational_coefficients)
        self._d = int(d)
        self._k = int(k)

    @property
    def d(self) -> int:
        return self._d

    @property
    def k(self) -> int:
        return self._k


class WendlandFunction(Function):
    """``phi_{d,k}(r) = p_{d,k}(r)`` on ``[0, 1]``, zero outside."""

    def __init__(self, d: int, k: int):
        super().__init__((), ())
        self._polynomial = WendlandPolynomial(d, k)

    @property
    def polynomial(self) -> WendlandPolynomial:
        return self._polynomial

    def _evaluate(self, r):
        return torch.where(r <= 1.0, self._polynomial._evaluate(r), torch.zeros_like(r))


class WendlandCovarianceFunction(StationaryMixin, CovarianceFunction):
    """Isotropic Wendland kernel ``k(x0, x1) = phi_{d,k}(||x0 - x1|| / l)``,
    ``2k`` times continuously differentiable."""

    def __init__(self, input_shape, k: int, lengthscales=None):
        super().__init__(input_shape)
        self._d = max(int(np.prod(self.input_shape)), 1)
        self._k = int(k)
        self._func = WendlandFunction(self._d, self._k)
        self._init_stationary(1.0 if lengthscales is None else lengthscales)
        self._scale_factors = 1.0 / self.lengthscales

    @property
    def d(self) -> int:
        return self._d

    @property
    def k(self) -> int:
        return self._k

    @property
    def func(self) -> WendlandFunction:
        return self._func

    def _evaluate(self, x0, x1):
        return self._func._evaluate(self._scaled_distances(x0, x1, self._scale_factors))
