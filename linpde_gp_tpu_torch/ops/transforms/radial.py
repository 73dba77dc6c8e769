r"""Closed-form diffop transforms of isotropic (radial) multivariate
half-integer Matérn kernels.

Port of ``linpde_gp_tpu/ops/transforms/radial.py``: directional
derivatives, weighted Laplacians and their combinations applied to
``Matern(input_shape=(d,), nu=p + 1/2)`` with ``d >= 2``.

Write ``z_i = c_i (x0_i - x1_i)`` with ``c_i = sqrt(2 nu) / l_i`` and
``t = ||z||``; the kernel is ``g(z) = phi(t)`` with ``phi(t) = q(t)
e^{-t}``.  The derivatives of a radial function obey the pairing formula

    d^gamma_z g = sum over pairings of the gamma index multiset of
                  (prod of deltas over pairs) (prod of z_i over singletons)
                  psi_{n-m}(t)

with ``n = |gamma|``, ``m`` pairs and ``psi_{k+1} = psi_k' / t``,
``psi_0 = phi``.  Each ``psi_k = s_k(t) t^{-j_k} e^{-t}`` follows from the
exact rational recurrence ``s_{k+1} = t s_k' - (j_k + t) s_k``, ``j_{k+1}
= j_k + 2`` (host ``Fraction`` tables, :func:`_psi`), and the value at
``z = 0`` comes from the even Taylor coefficients of ``phi``
(:func:`_gamma_zero_value`).  Then ``d^alpha_{x0} d^beta_{x1} k =
(-1)^{|beta|} (prod c^{alpha+beta}) d^{alpha+beta}_z g``.  The tables are
built on the host; the kernel evaluates in torch on its input's device
and dtype, with the exact value at ``z = 0``.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

from ...models.functions.polynomial import RationalPolynomial
from ..kernels.base import CovarianceFunction
from ..kernels.stationary import Matern, half_integer_matern_coefficients


@functools.lru_cache(maxsize=None)
def _psi(p: int, k: int):
    """``(s_k, j_k)`` with ``psi_k = s_k(t) t^{-j_k} e^{-t}``."""
    if k == 0:
        return RationalPolynomial(half_integer_matern_coefficients(p)), 0
    s_prev, j_prev = _psi(p, k - 1)
    t = RationalPolynomial([Fraction(0), Fraction(1)])
    s = t * s_prev.differentiate() - (RationalPolynomial([Fraction(j_prev)]) + t) * s_prev
    j = j_prev + 2
    # Reduce by the exact power of t dividing s.
    coeffs = list(s.rational_coefficients)
    val = 0
    while val < len(coeffs) - 1 and coeffs[val] == 0 and val < j:
        val += 1
    if val:
        coeffs = coeffs[val:]
        j -= val
    return RationalPolynomial(coeffs), j


@functools.lru_cache(maxsize=None)
def _phi_taylor_coeff(p: int, n: int) -> Fraction:
    """The ``t^n`` Taylor coefficient of ``phi(t) = q(t) e^{-t}``."""
    total = Fraction(0)
    for j, qj in enumerate(half_integer_matern_coefficients(p)):
        if j <= n:
            total += qj * Fraction((-1) ** (n - j), math.factorial(n - j))
    return total


def _pairings(indices):
    """Every split of the index list into pairs and singletons, as
    ``(pairs, singles)`` of index values."""
    if not indices:
        yield [], []
        return
    first, rest = indices[0], indices[1:]
    for pairs, singles in _pairings(rest):
        yield pairs, [first] + singles
    for pos in range(len(rest)):
        remaining = rest[:pos] + rest[pos + 1:]
        for pairs, singles in _pairings(remaining):
            yield [(first, rest[pos])] + pairs, singles


def _gamma_zero_value(p: int, gamma) -> Fraction:
    """The exact ``d^gamma g`` at ``z = 0``."""
    n = int(sum(gamma))
    if n % 2 == 1 or any(int(gi) % 2 for gi in gamma):
        return Fraction(0)
    coeff = Fraction(math.factorial(n // 2))
    for gi in gamma:
        coeff /= math.factorial(int(gi) // 2)
        coeff *= math.factorial(int(gi))
    return _phi_taylor_coeff(p, n) * coeff


class RadialMaternDerivativeKernel(CovarianceFunction):
    """``L0 k L1*`` for the isotropic multivariate half-integer Matérn."""

    def __init__(self, base: Matern, coeffs0, coeffs1):
        super().__init__(base.input_shape)
        self.base = base
        self.coeffs0 = coeffs0
        self.coeffs1 = coeffs1
        p = base.p
        c = np.asarray(base.scale_factors, dtype=np.float64).reshape(-1)
        d = c.shape[0]
        self._c = c

        def term_list(coeffs):
            if coeffs is None:
                return [(1.0, (0,) * d)]
            out = []
            for codomain_idx, mi, coeff in coeffs.items_flat():
                if codomain_idx != ():
                    raise ValueError("scalar codomain only")
                out.append((coeff, mi.factorize_dimwise()))
            return out

        # {(k, monomial): coefficient} and the exact value at z = 0.
        agg: dict = {}
        zero_limit = 0.0
        for c0v, alpha in term_list(coeffs0):
            for c1v, beta in term_list(coeffs1):
                gamma = tuple(a + b for a, b in zip(alpha, beta))
                n = sum(gamma)
                if n > 2 * p:
                    raise ValueError(f"derivative order {n} exceeds Matérn smoothness {2 * p}")
                pref = c0v * c1v * ((-1.0) ** sum(beta)) * float(np.prod(c ** np.asarray(gamma)))
                indices = [i for i, gi in enumerate(gamma) for _ in range(gi)]
                for pairs, singles in _pairings(indices):
                    if any(a != b for a, b in pairs):
                        continue
                    mono = [0] * d
                    for i in singles:
                        mono[i] += 1
                    key = (n - len(pairs), tuple(mono))
                    agg[key] = agg.get(key, 0.0) + pref
                zero_limit += pref * float(_gamma_zero_value(p, gamma))

        self._terms = []
        for (k, mono), coeff in agg.items():
            if coeff == 0.0:
                continue
            s_k, j_k = _psi(p, k)
            self._terms.append((float(coeff), mono, tuple(s_k.coefficients), int(j_k)))
        self._zero_limit = float(zero_limit)

    def _evaluate(self, x0, x1):
        d = torch.as_tensor(x0) - torch.as_tensor(x1)
        c = torch.as_tensor(self._c, dtype=d.dtype, device=d.device)
        z = (d * c[0])[..., None] if self.input_ndim == 0 else d * c
        t2 = torch.sum(z**2, dim=-1)
        is_zero = t2 == 0
        t = torch.sqrt(torch.where(is_zero, torch.ones_like(t2), t2))  # guarded sqrt
        expt = torch.exp(-t)
        total = None
        for coeff, mono, s_coeffs, j in self._terms:
            poly = torch.full_like(t, s_coeffs[-1])
            for ck in reversed(s_coeffs[:-1]):
                poly = poly * t + ck
            val = coeff * poly * expt
            if j:
                val = val / t**j
            for i, e in enumerate(mono):
                if e:
                    val = val * z[..., i] ** e
            total = val if total is None else total + val
        return torch.where(is_zero, torch.full_like(total, self._zero_limit), total)


def transform_radial_kernel(base, coeffs0, coeffs1):
    """The radial closed form for an isotropic multivariate half-integer
    Matérn, or ``None`` for anything else."""
    if not isinstance(base, Matern) or base.nu == np.inf or not base.is_half_integer:
        return None
    if base.input_size <= 1:
        return None  # the product route takes 1-D
    try:
        return RadialMaternDerivativeKernel(base, coeffs0, coeffs1)
    except ValueError:
        return None
