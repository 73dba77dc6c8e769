r"""Exact Lebesgue integrals and hat-basis projections of half-integer
Matérn kernels.

Port of ``linpde_gp_tpu/ops/transforms/integrals_exact.py``, formula for
formula.  With ``phi(s) = q(s) e^{-s}`` and ``Phi(s) = \int_0^s phi =
R(0) - R(s) e^{-s}``, ``R = sum_j q^{(j)}`` (exponential integration by
parts, exact in rational arithmetic on the host):

    \int_a^b phi(c|x - t|) dt = (1/c) [g(c(x-a)) - g(c(x-b))],   g(s) = sign(s) Phi(|s|)
    \int_a^b \int_a^b phi(c|s - t|) dt ds = (2/c^2) [R(0) T - S(0) + S(T) e^{-T}],
        S = sum_j R^{(j)},  T = c (b - a).

The host tables are ``Fraction``s, as in ``ops/gram.kernel_term_specs``;
the callables evaluate in torch on their input's device, and the hat x hat
double-projection Gram is formed in float64 on ``config.resolve_device()``
in row blocks of the output basis.  The differences of primitives are
taken in absolute coordinates, as in the JAX package, and cancel as the
elements shrink (ROADMAP Queue 3).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from math import comb

import numpy as np
import torch

from ...config import resolve_device
from ...models.functions.polynomial import RationalPolynomial
from ..kernels.stationary import Matern, half_integer_matern_coefficients

#: Entries of one ``(rows, 2, m2, 2)`` segment-pair table of
#: :func:`matern_hat_double_projection_gram` (each of its few dozen
#: temporaries is that size).
_PAIR_BLOCK_ELEMS = 1 << 22


@functools.lru_cache(maxsize=None)
def _exp_primitive_poly(coeffs_key) -> tuple:
    """``R = sum_j p^{(j)}``, so that ``d/ds [-R(s) e^{-s}] = p(s) e^{-s}``."""
    p = RationalPolynomial([Fraction(c) for c in coeffs_key])
    total = d = p
    for _ in range(p.degree):
        d = d.differentiate()
        total = total + d
    return tuple(total.rational_coefficients)


def _matern_R(p_order: int) -> RationalPolynomial:
    return RationalPolynomial(_exp_primitive_poly(tuple(half_integer_matern_coefficients(p_order))))


def _matern_Rt(p_order: int) -> RationalPolynomial:
    """``Rt = sum_j (s q)^{(j)}``: ``Psi(s) = \\int_0^s t q(t) e^{-t} dt =
    Rt(0) - Rt(s) e^{-s}`` (the first-moment primitive)."""
    q = half_integer_matern_coefficients(p_order)
    return RationalPolynomial(_exp_primitive_poly((Fraction(0),) + tuple(Fraction(c) for c in q)))


def _horner(coeffs, t):
    h = torch.full_like(t, coeffs[-1])
    for ck in reversed(coeffs[:-1]):
        h = h * t + ck
    return h


def _matern_c(nu: float, lengthscale: float) -> float:
    return float(np.sqrt(2 * nu) / lengthscale)


def matern_integral_crosscov(nu: float, lengthscale: float, a: float, b: float):
    """``x -> \\int_a^b k(x, t) dt`` for a 1-D Matérn, on torch tensors."""
    c = _matern_c(nu, lengthscale)
    r_coeffs = tuple(_matern_R(int(nu - 0.5)).coefficients)
    R0 = float(r_coeffs[0])

    def g(s):
        t = torch.abs(s)
        return torch.sign(s) * (R0 - _horner(r_coeffs, t) * torch.exp(-t))

    def evaluate(x):
        return (g(c * (x - a)) - g(c * (x - b))) / c

    return evaluate


def matern_double_integral(nu: float, lengthscale: float, a: float, b: float) -> float:
    """Exact ``\\int_a^b \\int_a^b k(s, t) dt ds`` for a 1-D Matérn."""
    c = _matern_c(nu, lengthscale)
    R = _matern_R(int(nu - 0.5))
    S = RationalPolynomial(_exp_primitive_poly(tuple(R.rational_coefficients)))
    T = c * (b - a)
    s_coeffs = S.coefficients
    horner = s_coeffs[-1]
    for ck in reversed(s_coeffs[:-1]):
        horner = horner * T + ck
    return (2.0 / c**2) * (float(R.coefficients[0]) * T - float(s_coeffs[0]) + horner * float(np.exp(-T)))


def _hat_segment_tables(basis):
    """Per-hat linear-piece tables ``(a, b, alpha, beta)``, each ``(m, 2)``
    numpy, the invalid boundary pieces zeroed (``w(t) = alpha t + beta`` on
    ``[a, b]``, as ``basis.eval_elem``)."""
    x_im1, x_i, x_ip1 = basis.x_im1, basis.x_i, basis.x_ip1
    ls = 1.0 / (x_i - x_im1)
    rs = 1.0 / (x_ip1 - x_i)
    a = np.stack([x_im1, x_i], axis=1)
    b = np.stack([x_i, x_ip1], axis=1)
    alpha = np.stack([ls, -rs], axis=1)
    beta = np.stack([-x_im1 * ls, x_ip1 * rs], axis=1)
    valid = np.ones_like(a, dtype=bool)
    if not basis.zero_boundary:
        valid[0, 0] = False  # the boundary hats' flat extensions are clamped to 0
        valid[-1, 1] = False
    return a, b, np.where(valid, alpha, 0.0), np.where(valid, beta, 0.0)


def matern_hat_projection_crosscov(nu: float, lengthscale: float, basis):
    r"""Exact ``x -> [\int phi_i(t) k(x, t) dt]_i`` for a half-integer Matérn.

    Each hat is two linear pieces ``w(t) = alpha t + beta`` on ``[a, b]``:

        \int_a^b (alpha t + beta) phi(c|t - x|) dt = (alpha x + beta) A(x) + alpha B(x),
        A(x) = (1/c)   [g(c(x-a)) - g(c(x-b))],   g(s) = sign(s) Phi(|s|),
        B(x) = -(1/c^2) [G(c(x-a)) - G(c(x-b))],   G(s) = Psi(|s|),

    with ``Phi`` / ``Psi`` the zeroth / first-moment primitives of ``q(s)
    e^{-s}``.  ``x``: ``(...,)`` scalar-domain points; returns ``(..., m)``.
    """
    p_order = int(nu - 0.5)
    c = _matern_c(nu, lengthscale)
    r_coeffs = tuple(_matern_R(p_order).coefficients)
    rt_coeffs = tuple(_matern_Rt(p_order).coefficients)
    R0, Rt0 = float(r_coeffs[0]), float(rt_coeffs[0])
    tables = _hat_segment_tables(basis)

    def g(s):  # odd primitive of phi(|.|)
        t = torch.abs(s)
        return torch.sign(s) * (R0 - _horner(r_coeffs, t) * torch.exp(-t))

    def G(s):  # even first-moment primitive
        t = torch.abs(s)
        return Rt0 - _horner(rt_coeffs, t) * torch.exp(-t)

    def evaluate(x):
        a, b, alpha, beta = (torch.as_tensor(t, dtype=x.dtype, device=x.device) for t in tables)
        xe = x[..., None, None]  # against the (m, 2) segment tables
        sa = c * (xe - a)
        sb = c * (xe - b)
        A = (g(sa) - g(sb)) / c
        B = -(G(sa) - G(sb)) / c**2
        return torch.sum((alpha * xe + beta) * A + alpha * B, dim=-1)

    return evaluate


def _shift_poly(coeffs, j: int):
    """Coefficients of ``u^j p(u)`` from those of ``p``."""
    return (Fraction(0),) * j + tuple(Fraction(c) for c in coeffs)


@functools.lru_cache(maxsize=None)
def _moment_primitive_tables(p_order: int, max_j: int, first_moment: bool):
    """Antiderivatives of ``u^j h(u)``, ``j = 0..max_j``, with ``h = g``
    (``first_moment=False``) or ``h = G``.  On ``u >= 0``, ``h(u) = H0 -
    H(u) e^{-u}`` and ``F_j(u) = H0 u^{j+1}/(j+1) + E_j(u) e^{-u}``, ``E_j =
    sum_k (u^j H)^{(k)}``.  Returns ``(H0, [(E_j coeffs, F_j(0), odd_j)])``:
    the global antiderivative is the odd or even extension set by the
    integrand's parity (``u^j g`` is odd for even ``j``, ``u^j G`` for odd
    ``j``; an odd integrand has an even antiderivative)."""
    base = _matern_Rt(p_order) if first_moment else _matern_R(p_order)
    base_c = tuple(base.rational_coefficients)
    rows = []
    for j in range(max_j + 1):
        e_j = _exp_primitive_poly(_shift_poly(base_c, j))
        integrand_odd = (j % 2 == 0) if not first_moment else (j % 2 == 1)
        rows.append((tuple(float(c) for c in e_j), float(e_j[0]), not integrand_odd))
    return float(base_c[0]), rows


def _eval_moment_primitive(u, h0, e_coeffs, f0, odd, j):
    """The global antiderivative of ``u^j h(u)`` at ``u``."""
    t = torch.abs(u)
    f_plus = h0 * t ** (j + 1) / (j + 1) + _horner(e_coeffs, t) * torch.exp(-t)
    if odd:
        return torch.sign(u) * (f_plus - f0)
    return f_plus


def matern_hat_double_projection_gram(nu: float, lengthscale: float, basis_out, basis_in) -> torch.Tensor:
    r"""Exact ``G_ij = \int\int w_i(s) w_j(t) k(s, t) dt ds`` for hat bases and
    a half-integer Matérn ``k``: the double-projection Gram block, float64 on
    ``config.resolve_device()``.

    The inner integral is the projection crosscov ``(alpha_2 s + beta_2)
    A(s) + alpha_2 B(s)``; the outer one of ``(alpha_1 s + beta_1)`` times it
    reduces to the moments ``\int s^m g(c(s - e)) ds`` (m <= 2) and ``\int
    s^m G(c(s - e)) ds`` (m <= 1), each an explicit antiderivative.  Formed
    in blocks of output rows (:data:`_PAIR_BLOCK_ELEMS`)."""
    p_order = int(nu - 0.5)
    c = _matern_c(nu, lengthscale)
    g0, g_rows = _moment_primitive_tables(p_order, 2, False)
    G0, G_rows = _moment_primitive_tables(p_order, 1, True)
    device = resolve_device()

    def tensors(tables, shape):
        return [torch.as_tensor(t, dtype=torch.float64, device=device).reshape(shape) for t in tables]

    out_tables = _hat_segment_tables(basis_out)
    a2, b2, al2, be2 = tensors(_hat_segment_tables(basis_in), (1, 1, -1, 2))
    m1, m2 = out_tables[0].shape[0], a2.shape[2]
    step = max(1, _PAIR_BLOCK_ELEMS // (4 * m2))
    out = torch.empty((m1, m2), dtype=torch.float64, device=device)
    for r in range(0, m1, step):
        a1, b1, al1, be1 = tensors([t[r:r + step] for t in out_tables], (-1, 2, 1, 1))

        def moment_integral(e, m, h0, rows):
            """``\\int_{a1}^{b1} s^m h(c(s - e)) ds`` over the pair grid."""
            u_hi = c * (b1 - e)
            u_lo = c * (a1 - e)
            total = 0.0
            for j in range(m + 1):
                e_coeffs, f0, odd = rows[j]
                d = _eval_moment_primitive(u_hi, h0, e_coeffs, f0, odd, j) - _eval_moment_primitive(
                    u_lo, h0, e_coeffs, f0, odd, j
                )
                total = total + comb(m, j) * e ** (m - j) * c ** (-j) * d
            return total / c

        # P2(s) = (al1 s + be1)(al2 s + be2) = p2 s^2 + p1 s + p0;  P1(s) = al2 (al1 s + be1).
        p2 = al1 * al2
        p1 = al1 * be2 + al2 * be1
        p0 = be1 * be2
        q1 = al2 * al1
        q0 = al2 * be1

        def contract_g(e):
            return (p0 * moment_integral(e, 0, g0, g_rows) + p1 * moment_integral(e, 1, g0, g_rows)
                    + p2 * moment_integral(e, 2, g0, g_rows))

        def contract_G(e):
            return q0 * moment_integral(e, 0, G0, G_rows) + q1 * moment_integral(e, 1, G0, G_rows)

        seg = (contract_g(a2) - contract_g(b2)) / c - (contract_G(a2) - contract_G(b2)) / c**2
        out[r:r + step] = seg.sum(dim=(1, 3))
    return out


def _half_integer_matern(kernel):
    """``(scale, nu, lengthscale)`` of a (scaled) 1-D half-integer Matérn,
    else ``None``."""
    from ..kernels.arithmetic import ScaledCovarianceFunction

    scale = 1.0
    k = kernel
    while isinstance(k, ScaledCovarianceFunction):
        scale *= k.scalar
        k = k.covfunc
    if not isinstance(k, Matern) or k.input_size > 1 or k.nu == np.inf or not k.is_half_integer:
        return None
    return scale, k.nu, float(np.ravel(k.lengthscales)[0])


def _hat_functional(functional):
    """``(basis, normalizer or None)`` of a hat-basis load vector or L2
    projection, else ``None``."""
    from ..functionals.projections import BasisIntegralFunctional, L2Projection_UnivariateLinearInterpolationBasis

    if isinstance(functional, L2Projection_UnivariateLinearInterpolationBasis):
        return functional.basis, (functional.normalizer if functional.normalized else None)
    if isinstance(functional, BasisIntegralFunctional):
        return functional.basis, None
    return None


def exact_projection_gram(functional_out, crosscov):
    """If ``crosscov`` is ``k L_in*`` with a (scaled) 1-D half-integer Matérn
    ``k`` and both ``functional_out`` and ``L_in`` hat-basis load vectors or
    L2 projections, the exact dense Gram block ``(functional_out.output_size,
    crosscov.randvar_size)``; else ``None``."""
    from ..crosscov.base import KernelFunctionalCrossCov

    if not isinstance(crosscov, KernelFunctionalCrossCov):
        return None
    out, inner = _hat_functional(functional_out), _hat_functional(crosscov.functional)
    matern = _half_integer_matern(crosscov.kernel)
    if out is None or inner is None or matern is None:
        return None
    (basis_out, norm_out), (basis_in, norm_in) = out, inner
    scale, nu, lengthscale = matern
    raw = scale * matern_hat_double_projection_gram(nu, lengthscale, basis_out, basis_in)
    if norm_out is not None:
        raw = norm_out.to(raw) @ raw
    if norm_in is not None:
        raw = raw @ norm_in.to(raw).T
    return raw


def exact_projection_crosscov(kernel, functional):
    """If ``kernel`` is a (scaled) 1-D half-integer Matérn and ``functional``
    a hat-basis load vector or L2 projection, the exact crosscov ``x ->
    (..., n_basis)`` on torch tensors; else ``None``."""
    hat, matern = _hat_functional(functional), _half_integer_matern(kernel)
    if hat is None or matern is None:
        return None
    basis, normalizer = hat
    scale, nu, lengthscale = matern
    fn = matern_hat_projection_crosscov(nu, lengthscale, basis)
    squeeze_input = kernel.input_shape == (1,)

    def crosscov_fn(x):
        if squeeze_input:
            x = x[..., 0]
        vals = scale * fn(x)
        if normalizer is not None:
            vals = vals @ normalizer.to(vals).T
        return vals

    return crosscov_fn


def exact_integral_hooks(kernel, functional):
    """If ``kernel`` is a (scaled) 1-D half-integer Matérn and ``functional``
    a Lebesgue integral over an Interval, ``(crosscov_fn, gram_value)``; else
    ``None``."""
    from ...models.domains import Interval
    from ..functionals.integrals import LebesgueIntegral

    if not isinstance(functional, LebesgueIntegral) or not isinstance(functional.domain, Interval):
        return None
    matern = _half_integer_matern(kernel)
    if matern is None:
        return None
    scale, nu, lengthscale = matern
    a, b = float(functional.domain[0]), float(functional.domain[1])
    fn = matern_integral_crosscov(nu, lengthscale, a, b)
    gram = scale * matern_double_integral(nu, lengthscale, a, b)

    def crosscov_fn(x):
        return scale * fn(x)

    return crosscov_fn, gram
