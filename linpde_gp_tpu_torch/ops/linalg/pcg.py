r"""Float-float preconditioned CG and the tail-damped Nyström
preconditioner.

Port of the main-path subset of ``linpde_gp_tpu/ops/linalg/pcg.py``:
:func:`pcg_ff` with its two step functions, the blocked multi-right-hand-
side :func:`pcg_block_ff` with its two step functions, the plain
:func:`pcg` and :func:`pcg_block`, the ff scalar helpers, :func:`ff_dot_cols` and
:func:`ff_norm2_cols`,
:class:`NystromPreconditioner` and its pair rule :func:`woodbury_apply`,
:func:`nystrom_preconditioner` (on formed blocks),
:func:`nystrom_preconditioner_device` with its products
:func:`nystrom_products`, :func:`landmark_indices`, and the
helpers :func:`as_ff` and :func:`lam1`.

Differences from the JAX package:

- The convergence check reads the current iteration's ``||r||^2`` (one
  host read per iteration) instead of the previous one, so
  ``iterations`` and ``relative_residual`` describe the returned ``x``;
  a zero right-hand side returns ``x = 0`` instead of NaN, and a
  breakdown (``r.z <= 0`` or a non-finite residual, seen in float32 below
  relres ~1e-7) stops with the last finite iterate instead of NaN.
- ``||r||^2`` is the sum of squares of ``hi + lo``, not ``ff_dot(r, r)``,
  whose hi part turns negative (and "converges") once the residual's
  planes cancel in float32.
- No 16384-row chunking of the ``(n, m)`` products: it worked around a
  TPU compile service, and the whole ``(1e5, 8192)`` block fits on the
  card.
- The matvec may return an ff pair, or a float64 result for float32
  state (the anchored Schur operator subtracts its correction in
  float64), which the CG splits into an ff pair instead of rounding it.
  The preconditioner sees the ff residual ``(r_hi, r_lo)`` and may return
  an ff pair (:class:`NystromPreconditioner` applies to ``hi + lo`` in its
  factors' float64 and returns the result's ff pair), and the right-hand
  side may be an ff pair (the variance's ``kxX`` from float64).  Each of
  these three was an f32 rounding that left the ff variance erring at
  first order in the CG residual (ROADMAP Queue 3).
- :func:`pcg_block_ff` carries these fixes per column: ``||r_j||^2 =
  sum (hi + lo)^2``, the test on the current iterate, a zero column
  returns 0, a breakdown column stops with its last finite iterate, the
  matvec sees the ff pair ``(P_hi, P_lo)`` (the JAX one passes ``P_hi``
  only) and the result is the ff pair ``(x, x_lo)`` (not ``hi + lo``
  rounded to float32).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ff import ff_add, ff_const, ff_mul, ff_split, quick_two_sum, two_prod, two_sum
from ...utils.profiling import span
from .chol import cholesky as robust_cholesky


class PCGResult(NamedTuple):
    x: torch.Tensor  # the ff solution rounded to one tensor
    iterations: int
    relative_residual: float
    x_lo: torch.Tensor  # the rounding error of ``x``: ``(x, x_lo)`` is the ff solution


# -- ff scalar helpers ---------------------------------------------------------


def ff_sub(x, y):
    s, e = two_sum(x[0], -y[0])
    return s, e + (x[1] - y[1])


def ff_div(a, b):
    """ff scalar division, accurate to ~eps^2 (one Newton correction)."""
    q1 = a[0] / b[0]
    p, e = two_prod(q1, b[0])
    rh, re = ff_sub(a, (p, e + q1 * b[1]))
    q2 = (rh + re) / b[0]
    return quick_two_sum(q1, q2)


def ff_dot(x, y):
    """Dot product of two ff vectors as an ff scalar: error-free
    per-element products, hi and lo streams summed separately and
    recombined in ff (~eps * log n relative)."""
    p, e = two_prod(x[0], y[0])
    lo = e + (x[0] * y[1] + x[1] * y[0])
    return two_sum(torch.sum(p), torch.sum(lo))


def ff_dot_cols(x, y):
    """Per-column dot products of two ``(n, r)`` ff arrays as an ``(r,)``
    ff pair (``pcg.py:497``; the blocked analogue of :func:`ff_dot`)."""
    p, e = two_prod(x[0], y[0])
    lo = e + (x[0] * y[1] + x[1] * y[0])
    return two_sum(torch.sum(p, 0), torch.sum(lo, 0))


def ff_norm2_cols(x):
    """Per-column ``||hi + lo||^2`` of an ``(n, r)`` ff array: a sum of
    squares, never negative.  (``ff_dot_cols(x, x)``'s hi plane turns
    negative once x's unnormalized planes cancel.)"""
    s = x[0] + x[1]
    return torch.sum(s * s, 0)


def _ff_axpy(alpha_ff, x_ff, y_ff):
    """y + alpha * x on ff vectors with an ff scalar alpha."""
    return ff_add(y_ff, ff_mul(x_ff, alpha_ff))


def as_ff(K, dtype: torch.dtype):
    """A matvec, preconditioner or right-hand side value as an ff pair in
    ``dtype``: an ff pair as it is, ``(K, 0)``, or a wider (float64)
    tensor split into ``hi + lo`` instead of rounded."""
    if isinstance(K, tuple):
        return K
    if K.dtype == dtype:
        return K, torch.zeros_like(K)
    return ff_split(K, dtype)


# -- CG ----------------------------------------------------------------------------


def _step_a(matvec, sigma_ff, x, p, r, rz):
    """Gram matvec, ``pAp`` and alpha, the x and r updates, ``||r||^2``.

    ``matvec`` is the UNSHIFTED Gram matvec of the ff pair ``p``; the
    ``sigma^2 I`` shift is applied in ff here."""
    with span("lgt.pcg.matvec"):
        Ap = matvec(p)
    Ap = ff_add(as_ff(Ap, p[0].dtype), ff_mul(p, sigma_ff))
    alpha = ff_div(rz, ff_dot(p, Ap))
    x_new = _ff_axpy(alpha, p, x)
    r_new = _ff_axpy((-alpha[0], -alpha[1]), Ap, r)
    # ||r||^2 of the rounded residual: a sum of squares, never negative.
    # (ff_dot(r, r) can come out negative once r's unnormalized planes
    # cancel, and would then pass any convergence threshold.)
    rr = r_new[0] + r_new[1]
    return x_new, r_new, torch.dot(rr, rr)


def _step_b(precond, r, r_old, p, rz_old):
    """Preconditioner apply, ``r.z`` and the Polak-Ribiere beta (clamped
    at 0, i.e. a restart), and the p update."""
    zf = r if precond is None else as_ff(precond(r), r[0].dtype)
    rz_new = ff_dot(r, zf)
    beta = ff_div(ff_sub(rz_new, ff_dot(zf, r_old)), rz_old)
    neg = beta[0] < 0  # stays on the device: no host sync here
    beta = tuple(torch.where(neg, torch.zeros_like(c), c) for c in beta)
    return ff_add(zf, ff_mul(p, beta)), rz_new


def pcg_ff(
    matvec: Callable,
    precond: Callable | None,
    b: torch.Tensor,
    sigma_sq: float,
    *,
    tol: float = 1e-6,
    maxiter: int = 512,
) -> PCGResult:
    """Solve ``(K + sigma_sq I) x = b`` by flexible (Polak-Ribiere)
    preconditioned CG with float-float vector state.

    ``matvec((v_hi, v_lo))`` applies the unshifted ``K`` to an ff pair and
    returns an ff pair or one tensor in ``b``'s dtype (or in float64,
    split into an ff pair); a matvec that reads only ``v_hi`` drops ``K
    v_lo``, ~eps of ``sum |K| |v|``.  ``precond((r_hi, r_lo))`` applies an
    approximation of ``(K + sigma_sq I)^{-1}`` (``None``: identity) and
    returns the same kinds.  ``b`` is a tensor or an ff pair ``(hi, lo)``.
    All state stays on ``b``'s device; the host reads one scalar per
    iteration.  The solution is ``x + x_lo`` of the result.
    """
    with span("lgt.pcg"):
        b = as_ff(b, b.dtype) if torch.is_tensor(b) else b
        dtype = b[0].dtype
        zeros = torch.zeros_like(b[0])
        with span("lgt.host_read"):
            b_norm = float(torch.linalg.vector_norm(b[0].to(torch.float64) + b[1].to(torch.float64)))
        if b_norm == 0.0:
            return PCGResult(zeros, 0, 0.0, zeros)
        sigma_ff = tuple(torch.tensor(c, dtype=dtype, device=zeros.device) for c in ff_const(float(sigma_sq), dtype))
        x = (zeros, zeros)
        r = b
        one = (torch.ones((), dtype=dtype, device=zeros.device), torch.zeros((), dtype=dtype, device=zeros.device))
        p, rz = _step_b(precond, r, (zeros, zeros), (zeros, zeros), one)
        threshold2 = (tol * b_norm) ** 2

        k = 0
        rn2 = b_norm**2
        while k < maxiter:
            r_old, x_old = r, x
            x, r, rn2_t = _step_a(matvec, sigma_ff, x, p, r, rz)
            p, rz = _step_b(precond, r, r_old, p, rz)
            # One host read per iteration: ||r||^2 and r.z together.
            with span("lgt.host_read"):
                rn2_k, rz_k = torch.stack([rn2_t, rz[0]]).tolist()
            if not np.isfinite(rn2_k):
                x = x_old
                break
            k, rn2 = k + 1, rn2_k
            # r.z <= 0: the preconditioned residual lost definiteness at the
            # working precision (float32 stagnation), and beta would divide
            # by it next; stop with the current iterate.
            if rn2 <= threshold2 or not rz_k > 0:
                break
        relres = float(np.sqrt(rn2)) / b_norm
        x_hi, x_lo = two_sum(x[0], x[1])
        return PCGResult(x_hi, k, relres, x_lo)


# -- plain CG ---------------------------------------------------------------------------


def pcg(
    matvec: Callable, b: torch.Tensor, *, M: Callable | None = None, tol: float = 1e-6, maxiter: int = 512,
    x0: torch.Tensor | None = None,
) -> PCGResult:
    """Solve ``A x = b`` (A SPD) by preconditioned CG in ``b``'s dtype
    (``pcg.py:40`` of the JAX package): flexible Polak-Ribiere beta clamped
    at 0, stopping once ``||r|| <= tol ||b||`` (``tol`` absolute for ``b =
    0``, which returns ``x0`` or zero in 0 iterations) or at ``maxiter``;
    the host reads ``||r||`` once per iteration.  ``M`` applies an
    approximation of ``A^{-1}``; ``x_lo`` of the result is zero.

    >>> import torch
    >>> d = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    >>> res = pcg(lambda v: d * v, torch.ones(3, dtype=torch.float64), tol=1e-12)
    >>> int(res.iterations)
    3
    >>> [round(float(x), 6) for x in res.x]
    [1.0, 0.5, 0.333333]
    """
    if M is None:
        M = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b if x0 is None else b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    b_norm = float(torch.linalg.vector_norm(b))
    threshold = tol * (b_norm if b_norm > 0 else 1.0)
    k = 0
    r_norm = float(torch.linalg.vector_norm(r))
    while r_norm > threshold and k < maxiter:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = torch.dot(r_new, z)
        beta = torch.clamp((rz_new - torch.dot(z, r)) / rz, min=0.0)
        p = z + beta * p
        r, rz = r_new, rz_new
        r_norm = float(torch.linalg.vector_norm(r))
        k += 1
    return PCGResult(x, k, r_norm / (b_norm if b_norm > 0 else 1.0), torch.zeros_like(x))


# -- blocked CG: many right-hand sides through one shared matvec -----------------------


def pcg_block(
    matvec: Callable, B: torch.Tensor, *, M: Callable | None = None, tol: float = 1e-6, maxiter: int = 512
) -> PCGResult:
    """Solve ``A X = B`` for a block of right-hand sides sharing one
    ``matvec((n, r))`` per iteration, in ``B``'s dtype (``pcg.py:173`` of
    the JAX package): flexible Polak-Ribiere CG per column, beta clamped at
    0, converged columns frozen by masked updates; the loop ends when
    every column's ``||r_j|| <= tol ||b_j||`` or at ``maxiter``.  The host
    reads one flag per iteration.  ``x_lo`` of the result is zero."""
    if M is None:
        M = lambda r: r  # noqa: E731
    X = torch.zeros_like(B)
    R = B
    Z = M(R)
    P = Z
    rz = torch.sum(R * Z, 0)
    b_norm = torch.linalg.vector_norm(B, dim=0)
    threshold = tol * torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))
    k = 0
    active = torch.linalg.vector_norm(R, dim=0) > threshold
    while k < maxiter and bool(active.any()):
        AP = matvec(P)
        pAp = torch.sum(P * AP, 0)
        alpha = torch.where(active, rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp)), torch.zeros_like(rz))
        X = X + alpha * P
        R_new = R - alpha * AP
        Z = M(R_new)
        rz_new = torch.sum(R_new * Z, 0)
        pr = rz_new - torch.sum(Z * R, 0)
        beta = torch.where(
            active, torch.clamp(pr / torch.where(rz != 0, rz, torch.ones_like(rz)), min=0.0), torch.zeros_like(rz)
        )
        P = Z + beta * P
        R, rz = R_new, torch.where(active, rz_new, rz)
        active = torch.linalg.vector_norm(R, dim=0) > threshold
        k += 1
    relres = float(torch.max(torch.linalg.vector_norm(R, dim=0) / torch.where(b_norm > 0, b_norm, 1.0)))
    return PCGResult(X, k, relres, torch.zeros_like(X))


def _any(flags: torch.Tensor) -> bool:
    """Whether any flag is set: one read of the device by the host."""
    with span("lgt.host_read"):
        return bool(flags.any())


def _block_step_a(matvec, sigma_ff, X, P, R, rz, active):
    """The blocked ``_step_a``: one shared matvec of the ``(n, r)`` ff pair
    ``P``, per-column alpha (0 where frozen) and ``||r_j||^2`` (a sum of
    squares of ``hi + lo``, never negative)."""
    with span("lgt.pcg.matvec"):
        AP = matvec(P)
    AP = ff_add(as_ff(AP, P[0].dtype), ff_mul(P, sigma_ff))
    pAp = ff_dot_cols(P, AP)
    safe = (pAp[0] != 0) & active
    alpha = ff_div(rz, (torch.where(safe, pAp[0], 1.0), torch.where(safe, pAp[1], 0.0)))
    alpha = tuple(torch.where(safe, c, 0.0)[None, :] for c in alpha)
    X_new = _ff_axpy(alpha, P, X)
    R_new = _ff_axpy((-alpha[0], -alpha[1]), AP, R)
    return X_new, R_new, ff_norm2_cols(R_new)


def _block_step_b(precond, R, R_old, P, rz_old, active):
    """The blocked ``_step_b``: preconditioner apply, per-column ``r.z``
    and the Polak-Ribiere beta (0 where frozen or negative), the P update."""
    Zf = R if precond is None else as_ff(precond(R), R[0].dtype)
    rz_new = ff_dot_cols(R, Zf)
    num = ff_sub(rz_new, ff_dot_cols(Zf, R_old))
    safe = (rz_old[0] != 0) & active
    beta = ff_div(num, (torch.where(safe, rz_old[0], 1.0), torch.where(safe, rz_old[1], 0.0)))
    keep = safe & (beta[0] > 0)
    beta = tuple(torch.where(keep, c, 0.0)[None, :] for c in beta)
    return ff_add(Zf, ff_mul(P, beta)), rz_new


def pcg_block_ff(
    matvec: Callable,
    precond: Callable | None,
    B: torch.Tensor,
    sigma_sq: float,
    *,
    tol: float = 1e-6,
    maxiter: int = 512,
) -> PCGResult:
    """Solve ``(K + sigma_sq I) X = B`` for the ``r`` columns of ``B``
    (``(n, r)``) by flexible preconditioned CG with float-float state and
    one shared ``matvec`` per iteration (``pcg.py:560`` of the JAX
    package, with the fixes of :func:`pcg_ff` per column).

    ``matvec((P_hi, P_lo))`` applies the unshifted ``K`` to an ``(n, r)``
    ff pair and returns an ``(n, r)`` ff pair, or ``(n, r)`` in ``B``'s
    dtype or in float64; ``precond`` takes an ``(n, r)`` ff pair and
    returns the same kinds.  ``B`` is ``(n, r)`` or an ff pair of those.
    Column ``j`` stops when
    ``||r_j|| <= tol ||b_j||`` (on the current iterate), at breakdown
    (``r_j.z_j <= 0``, or a non-finite residual, which returns the last
    finite iterate) or at ``maxiter``; a stopped column is frozen by masked
    updates, and a zero column returns 0.  All state stays on ``B``'s
    device; the host reads one flag per iteration.  The solution is ``x +
    x_lo`` of the result; ``relative_residual`` is the largest column's,
    ``iterations`` the loop's count.
    """
    with span("lgt.pcg_block"):
        B = as_ff(B, B.dtype) if torch.is_tensor(B) else B
        dtype = B[0].dtype
        zeros = torch.zeros_like(B[0])
        b_norm2 = torch.sum((B[0].to(torch.float64) + B[1].to(torch.float64)) ** 2, 0)
        threshold2 = tol**2 * b_norm2
        sigma_ff = tuple(torch.tensor(c, dtype=dtype, device=zeros.device) for c in ff_const(float(sigma_sq), dtype))
        X = (zeros, zeros)
        R = B
        ones = torch.ones(zeros.shape[1], dtype=dtype, device=zeros.device)
        active = b_norm2 > 0
        P, rz = _block_step_b(precond, R, (zeros, zeros), (zeros, zeros), (ones, torch.zeros_like(ones)), active)
        rn2 = b_norm2
        k = 0
        while k < maxiter and _any(active):
            X_old, R_old = X, R
            X, R, rn2_t = _block_step_a(matvec, sigma_ff, X, P, R, rz, active)
            # A column whose residual turned non-finite keeps its last finite iterate.
            moved = active & torch.isfinite(rn2_t)
            X = tuple(torch.where(moved[None, :], a, b) for a, b in zip(X, X_old))
            R = tuple(torch.where(moved[None, :], a, b) for a, b in zip(R, R_old))
            rn2 = torch.where(moved, rn2_t.to(torch.float64), rn2)
            P, rz = _block_step_b(precond, R, R_old, P, rz, moved)
            # r.z <= 0: the column lost definiteness at the working precision
            # (as in pcg_ff); stop it with the current iterate.
            active = moved & (rn2 > threshold2) & (rz[0] > 0)
            k += 1
        b_norm2 = torch.where(b_norm2 > 0, b_norm2, 1.0)
        with span("lgt.host_read"):
            relres = float(torch.max(torch.sqrt(rn2 / b_norm2))) if zeros.shape[1] else 0.0
        x_hi, x_lo = two_sum(X[0], X[1])
        return PCGResult(x_hi, k, relres, x_lo)


# -- Nyström preconditioner ---------------------------------------------------------


class NystromPreconditioner(NamedTuple):
    """Tail-damped Nyström preconditioner ``P = delta I + B B^T`` with
    ``B = K_XZ L_ZZ^{-T}`` and ``delta = lambda_m + sigma^2`` (Frangella,
    Tropp & Udell, SIMAX 2023), applied by the Cholesky-based Woodbury
    identity

        P^{-1} r = (r - B (delta I + B^T B)^{-1} B^T r) / delta.
    """

    B: torch.Tensor  # (n, m)
    chol_C: torch.Tensor  # (m, m) lower Cholesky of delta I + B^T B
    delta: torch.Tensor  # lambda_m + sigma^2

    def __call__(self, r):
        """``P^{-1} r`` by :func:`woodbury_apply`."""
        with span("lgt.nystrom.apply"):
            return woodbury_apply(r, self.B.dtype, self._apply)

    def _apply(self, rr):
        return (rr - self.B @ torch.cholesky_solve(self.B.T @ rr, self.chol_C)) / self.delta


def woodbury_apply(r, dtype: torch.dtype, apply: Callable):
    """``apply`` (a Woodbury apply on ``(n, k)`` columns in its factors'
    ``dtype``) to a tensor ``r`` (``(n,)`` or ``(n, k)``), returned in its
    dtype, or to an ff pair ``(hi, lo)``: applied to ``hi + lo`` in
    ``dtype`` where it is wider than the pair's (float64 factors, float32
    pairs: mode ff), else to ``hi``, and returned as the result's ff pair in
    ``hi``'s dtype (a float64 result split, not rounded)."""
    pair = isinstance(r, tuple)
    r_dtype = r[0].dtype if pair else r.dtype
    if pair and torch.finfo(dtype).eps < torch.finfo(r_dtype).eps:
        rr = r[0].to(dtype) + r[1].to(dtype)
    else:
        rr = (r[0] if pair else r).to(dtype)
    vector = rr.ndim == 1
    out = apply(rr[:, None] if vector else rr)
    out = out[:, 0] if vector else out
    return as_ff(out, r_dtype) if pair else out.to(r_dtype)


def nystrom_preconditioner(K_XZ, K_ZZ, sigma_sq) -> NystromPreconditioner:
    """The tail-damped inverse of ``Nystrom(K) + sigma^2 I`` from a formed
    ``(n, m)`` block ``K_XZ`` against ``m`` landmarks and their ``(m, m)``
    Gram ``K_ZZ`` (``pcg.py:796`` of the JAX package, in the tensors' dtype
    and on their device): ``K_ZZ`` stabilized by ``eps trace(K_ZZ) m``,
    ``delta = max(lambda_min(C0), 100 eps lambda_max(C0)) + sigma^2`` from
    ``C0 = B^T B``'s eigenvalues.  A factorization that fails after the
    Cholesky ladder raises ``torch.linalg.LinAlgError`` (the JAX package
    returns NaN factors).

    >>> import torch
    >>> K = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    >>> P = nystrom_preconditioner(K, K, 0.1)
    >>> r = torch.tensor([1.0, -1.0], dtype=torch.float64)
    >>> bool(torch.allclose((K + P.delta * torch.eye(2, dtype=torch.float64)) @ P(r), r))
    True
    """
    K_XZ, K_ZZ = torch.as_tensor(K_XZ), torch.as_tensor(K_ZZ)
    m = K_ZZ.shape[0]
    eps = torch.finfo(K_ZZ.dtype).eps
    eye = torch.eye(m, dtype=K_ZZ.dtype, device=K_ZZ.device)
    L = robust_cholesky(K_ZZ + (eps * float(torch.trace(K_ZZ)) * m) * eye, jitter=0.0)
    B = K_XZ @ torch.linalg.solve_triangular(L, eye, upper=False).T
    C0 = B.T @ B
    C0 = 0.5 * (C0 + C0.T)
    lam = torch.linalg.eigvalsh(C0)
    lam_m = max(float(lam[0]), 100.0 * eps * max(float(lam[-1]), 0.0))
    delta = lam_m + float(sigma_sq)
    chol_C = robust_cholesky(C0 + delta * eye, jitter=0.0)
    return NystromPreconditioner(B, chol_C, torch.tensor(delta, dtype=K_ZZ.dtype, device=K_ZZ.device))


def lam1(A, iters=16):
    """Largest eigenvalue of a PSD matrix by power iteration."""
    m = A.shape[0]
    v = torch.ones(m, dtype=A.dtype, device=A.device) / np.sqrt(m)
    for _ in range(iters):
        w = A @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return float(torch.linalg.vector_norm(A @ v))


#: The Nyström build's products in column panels (:func:`nystrom_products`):
#: this many panels, each a multiple of :data:`PANEL_ALIGN` wide, from a rank
#: of :data:`PANEL_MIN_RANK` on; below it one product each.
NYSTROM_PANELS = 8
PANEL_ALIGN = 128
PANEL_MIN_RANK = 1024


def nystrom_panel_width(m: int) -> int:
    """The panel width of :func:`nystrom_products` at rank ``m``: ``m``
    over :data:`NYSTROM_PANELS`, rounded up to a multiple of
    :data:`PANEL_ALIGN`, or ``m`` (one panel) below :data:`PANEL_MIN_RANK`."""
    if m < PANEL_MIN_RANK:
        return m
    return -(-m // (NYSTROM_PANELS * PANEL_ALIGN)) * PANEL_ALIGN


def nystrom_products(K_XZ: torch.Tensor, L_inv_T: torch.Tensor, nb: int | None = None):
    """``B = K_XZ L^{-T}`` and ``C0 = B^T B``, exactly symmetric, for an
    ``(n, m)`` block ``K_XZ`` and the upper triangular ``L_inv_T``.

    From a rank ``m`` of :data:`PANEL_MIN_RANK` on, both are formed in
    column panels of ``nb`` (``None``: :func:`nystrom_panel_width`; tests
    set it), which skip the exact zeros below ``L_inv_T``'s diagonal and
    the lower half of ``C0``: with ``p`` panels each product does
    ``(1 + 1/p) / 2`` of the full one's multiply-adds.  ``B``'s panel
    ``j`` is ``K_XZ``'s first ``j + 1`` panels times ``L_inv_T``'s blocks
    on and above the diagonal in column ``j``; ``C0``'s row panel ``i`` is
    ``B``'s panel ``i`` against ``B``'s columns from ``i`` on, and the
    strict upper triangle is then mirrored.  ``nb >= m`` is the single
    product of each.
    """
    n, m = K_XZ.shape
    nb = nystrom_panel_width(m) if nb is None else nb
    if nb >= m:
        B = K_XZ @ L_inv_T
        del K_XZ
        C0 = B.T @ B
        return B, 0.5 * (C0 + C0.T)
    with span("lgt.nystrom.panels"):
        B = torch.empty((n, m), dtype=K_XZ.dtype, device=K_XZ.device)
        for j0 in range(0, m, nb):
            j1 = min(m, j0 + nb)
            torch.mm(K_XZ[:, :j1], L_inv_T[:j1, j0:j1], out=B[:, j0:j1])
        del K_XZ  # freed before C0 is formed where the caller keeps no reference
        C0 = torch.empty((m, m), dtype=B.dtype, device=B.device)
        for i0 in range(0, m, nb):
            torch.mm(B[:, i0:i0 + nb].T, B[:, i0:], out=C0[i0:i0 + nb, i0:])
        C0.triu_()
        C0 += C0.triu(1).T
    return B, C0


def nystrom_preconditioner_device(
    block_fn: Callable,
    X: torch.Tensor,
    Z: torch.Tensor,
    sigma_sq: float,
    *,
    f32_floor: float = 8.0,
    dtype: torch.dtype | None = None,
) -> NystromPreconditioner:
    """All-device floored Nyström build (``pcg.py:994`` of the JAX package).

    ``block_fn(x0, x1) -> (n0, n1)`` evaluates kernel blocks in ``X``'s
    dtype; the factors are built, stored and applied in ``dtype``
    (default: ``X``'s).  The K_ZZ stabilizer is floored at ``f32_floor *
    eps * lambda_1(K_ZZ)`` with ``eps`` of the blocks' dtype, since their
    rounding can make ``K_ZZ`` indefinite at that level; the damping
    delta is floored at ``f32_floor * eps * lambda_1(C0)`` with ``eps`` of
    ``dtype``, the Woodbury apply's cancellation limit.  In float64 the
    floors are ~1e-15 relative and never bind.  ``B`` and ``C0 = B^T B``
    come from :func:`nystrom_products`.
    """
    m = Z.shape[0]
    dtype = X.dtype if dtype is None else dtype
    eps_blocks = torch.finfo(X.dtype).eps
    eps_dev = torch.finfo(dtype).eps
    eye = torch.eye(m, dtype=dtype, device=X.device)

    K_ZZ = block_fn(Z, Z).to(dtype)
    K_ZZ = 0.5 * (K_ZZ + K_ZZ.T)
    nu = f32_floor * eps_blocks * lam1(K_ZZ)
    L = robust_cholesky(K_ZZ + nu * eye, jitter=0.0)
    del K_ZZ
    L_inv_T = torch.linalg.solve_triangular(L, eye, upper=False).T
    del L
    B, C0 = nystrom_products(block_fn(X, Z).to(dtype), L_inv_T)
    del L_inv_T
    lam1_c0 = lam1(C0)

    # lambda_min(C0) by inverse iteration against a minimally stabilized
    # factor (the tail damping needs it where it exceeds the floor).
    chol0 = robust_cholesky(C0, jitter=eps_dev)
    v = torch.ones(m, dtype=dtype, device=X.device) / np.sqrt(m)
    for _ in range(24):
        w = torch.cholesky_solve(v[:, None], chol0)[:, 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    lam_m = max(float(v @ (C0 @ v)), 0.0)
    del chol0
    delta = max(lam_m, f32_floor * eps_dev * lam1_c0) + float(sigma_sq)
    chol_C = robust_cholesky(C0 + delta * eye, jitter=0.0)
    return NystromPreconditioner(B, chol_C, torch.tensor(delta, dtype=dtype, device=X.device))


def landmark_indices(n: int, m: int, device=None) -> torch.Tensor:
    """``m`` deterministic, evenly spread landmark indices in ``[0, n)``,
    computed in float64 as the JAX package does under x64."""
    m = int(min(m, n))
    idx = ((np.arange(m, dtype=np.float64) + 0.5) * (n / m)).astype(np.int32)
    return torch.as_tensor(idx.astype(np.int64), device=device)
