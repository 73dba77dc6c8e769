r"""Closed-form 1-D operator-transformed kernel factors.

Port of ``linpde_gp_tpu/ops/transforms/univariate.py``: the exact
polynomial form of ``d^m_{x0} d^n_{x1} k(x0, x1)`` for any orders, from
host-side rational recurrences (``d = x0 - x1``, ``N = m + n``):

- Matérn (``nu = p + 1/2``, ``t = c|d|``, ``c = sqrt(2 nu)/l``):
  ``(-1)^n c^N sign(d)^{N mod 2} r_N(t) e^{-t}`` with
  ``r_{N+1} = r_N' - r_N``;
- Gaussian (``z = d/(sqrt(2) l)``): ``(-1)^n (sqrt(2) l)^{-N} p_N(z)
  e^{-z^2}`` with ``p_{N+1} = p_N' - 2 z p_N``;
- Wendland (``t = |d|/l``): ``(-1)^n l^{-N} sign(d)^{N mod 2} p^{(N)}(t)
  1_{t<=1}``.

Smoothness makes ``r_N(0) = 0`` (resp. ``p^{(N)}(0) = 0``) for odd
admissible ``N``, so ``sign(0) = 0`` selects the exact diagonal limit.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from ...models.functions.polynomial import RationalPolynomial


class UnivariateFactor:
    """A 1-D kernel factor ``f(x0, x1)``: polynomial profile times
    envelope, with an optional sign parity.  ``(kind, scale, poly, parity,
    prefactor)`` is one factor of a term spec."""

    __slots__ = ("kind", "scale", "poly", "parity", "prefactor")

    def __init__(self, kind: str, scale: float, poly, parity: int, prefactor: float):
        if kind not in ("matern", "expquad", "wendland"):
            raise ValueError(f"unknown factor kind {kind!r}")
        self.kind = kind
        self.scale = float(scale)
        self.poly = tuple(float(c) for c in poly)
        self.parity = int(parity)
        self.prefactor = float(prefactor)

    def __call__(self, x0, x1):
        d = x0 - x1
        if self.kind == "matern":
            t = self.scale * torch.abs(d)
            val = self._horner(t) * torch.exp(-t)
            if self.parity:
                val = val * torch.sign(d)
        elif self.kind == "wendland":
            t = self.scale * torch.abs(d)
            val = torch.where(t <= 1.0, self._horner(t), torch.zeros_like(t))
            if self.parity:
                val = val * torch.sign(d)
        else:
            z = self.scale * d
            val = self._horner(z) * torch.exp(-(z**2))
        return self.prefactor * val

    def _horner(self, t):
        res = torch.full_like(t, self.poly[-1])
        for c in reversed(self.poly[:-1]):
            res = res * t + c
        return res

    def __repr__(self):
        return (
            f"UnivariateFactor({self.kind}, scale={self.scale}, "
            f"poly={self.poly}, parity={self.parity}, pref={self.prefactor})"
        )


@functools.lru_cache(maxsize=None)
def _matern_derivative_polynomial(p: int, N: int) -> RationalPolynomial:
    from ..kernels.stationary import half_integer_matern_coefficients

    poly = RationalPolynomial(half_integer_matern_coefficients(p))
    for _ in range(N):
        poly = poly.differentiate() - poly
    return poly


@functools.lru_cache(maxsize=None)
def _gaussian_derivative_polynomial(N: int) -> RationalPolynomial:
    poly = RationalPolynomial([Fraction(1)])
    for _ in range(N):
        poly = poly.differentiate() - RationalPolynomial([Fraction(0), Fraction(2)]) * poly
    return poly


@functools.lru_cache(maxsize=None)
def _wendland_derivative_polynomial(d_dim: int, k: int, N: int) -> RationalPolynomial:
    from ..kernels.wendland import wendland_polynomial

    poly = wendland_polynomial(d_dim, k)
    for _ in range(N):
        poly = poly.differentiate()
    return poly


def matern_factor(nu: float, lengthscale: float, m: int, n: int) -> UnivariateFactor:
    """``d^m_{x0} d^n_{x1}`` of a 1-D Matérn kernel with smoothness ``nu``."""
    if nu == np.inf:
        return expquad_factor(lengthscale, m, n)
    p = int(nu - 0.5)
    if float(nu) != p + 0.5:
        raise ValueError(f"only half-integer nu has closed forms, got {nu}")
    N = m + n
    if N > 2 * p:
        raise ValueError(
            f"Matérn(nu={nu}) is only {2 * p}-times differentiable; requested total derivative order {N}."
        )
    c = float(np.sqrt(2 * nu) / lengthscale)
    poly = _matern_derivative_polynomial(p, N)
    prefactor = ((-1.0) ** n) * c**N
    return UnivariateFactor("matern", c, poly.coefficients, parity=N % 2, prefactor=prefactor)


def expquad_factor(lengthscale: float, m: int, n: int) -> UnivariateFactor:
    """``d^m_{x0} d^n_{x1}`` of a 1-D ExpQuad kernel."""
    N = m + n
    s = 1.0 / (np.sqrt(2.0) * float(lengthscale))
    poly = _gaussian_derivative_polynomial(N)
    prefactor = ((-1.0) ** n) * s**N
    return UnivariateFactor("expquad", s, poly.coefficients, parity=0, prefactor=prefactor)


def wendland_factor(d_dim: int, k: int, lengthscale: float, m: int, n: int) -> UnivariateFactor:
    """``d^m_{x0} d^n_{x1}`` of a 1-D Wendland ``phi_{d,k}`` kernel
    (``N = m + n <= 2k``)."""
    N = m + n
    if N > 2 * k:
        raise ValueError(
            f"Wendland(d={d_dim}, k={k}) is only {2 * k}-times differentiable; requested total derivative order {N}."
        )
    c = 1.0 / float(lengthscale)
    poly = _wendland_derivative_polynomial(int(d_dim), int(k), N)
    prefactor = ((-1.0) ** n) * c**N
    return UnivariateFactor("wendland", c, poly.coefficients, parity=N % 2, prefactor=prefactor)
