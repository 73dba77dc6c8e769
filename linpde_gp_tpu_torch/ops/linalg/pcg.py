r"""Float-float preconditioned CG and the tail-damped Nyström
preconditioner.

Port of the main-path subset of ``linpde_gp_tpu/ops/linalg/pcg.py``:
:func:`pcg_ff` with its two step functions, the ff scalar helpers,
:class:`NystromPreconditioner`, :func:`nystrom_preconditioner_device`
and :func:`landmark_indices`.

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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ff import ff_add, ff_const, ff_mul, quick_two_sum, two_prod, two_sum
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


def _ff_axpy(alpha_ff, x_ff, y_ff):
    """y + alpha * x on ff vectors with an ff scalar alpha."""
    return ff_add(y_ff, ff_mul(x_ff, alpha_ff))


# -- CG ----------------------------------------------------------------------------


def _step_a(matvec, sigma_ff, x, p, r, rz):
    """Gram matvec, ``pAp`` and alpha, the x and r updates, ``||r||^2``.

    ``matvec`` is the UNSHIFTED Gram matvec of the ff pair ``p``; the
    ``sigma^2 I`` shift is applied in ff here."""
    Kp = matvec(p)
    Ap = ff_add((Kp, torch.zeros_like(Kp)), ff_mul(p, sigma_ff))
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
    z = r[0] if precond is None else precond(r[0])
    zf = (z, torch.zeros_like(z))
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
    returns one tensor in ``b``'s dtype; a matvec that reads only ``v_hi``
    drops ``K v_lo``, ~eps of ``sum |K| |v|``.  ``precond(r)`` applies an
    approximation of ``(K + sigma_sq I)^{-1}`` (``None``: identity).  All
    state stays on ``b``'s device; the host reads one scalar per
    iteration.  The solution is ``x + x_lo`` of the result.
    """
    dtype = b.dtype
    zeros = torch.zeros_like(b)
    b_norm = float(torch.linalg.vector_norm(b.to(torch.float64)))
    if b_norm == 0.0:
        return PCGResult(zeros, 0, 0.0, zeros)
    sigma_ff = tuple(torch.tensor(c, dtype=dtype, device=b.device) for c in ff_const(float(sigma_sq), dtype))
    x = (zeros, zeros)
    r = (b, zeros)
    one = (torch.ones((), dtype=dtype, device=b.device), torch.zeros((), dtype=dtype, device=b.device))
    p, rz = _step_b(precond, r, (zeros, zeros), (zeros, zeros), one)
    threshold2 = (tol * b_norm) ** 2

    k = 0
    rn2 = b_norm**2
    while k < maxiter:
        r_old, x_old = r, x
        x, r, rn2_t = _step_a(matvec, sigma_ff, x, p, r, rz)
        p, rz = _step_b(precond, r, r_old, p, rz)
        # One host read per iteration: ||r||^2 and r.z together.
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

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        # Applied in the factors' precision, returned in the residual's.
        vector = r.ndim == 1
        rr = (r[:, None] if vector else r).to(self.B.dtype)
        w = torch.cholesky_solve(self.B.T @ rr, self.chol_C)
        out = ((rr - self.B @ w) / self.delta).to(r.dtype)
        return out[:, 0] if vector else out


def _lam1(A, iters=16):
    """Largest eigenvalue of a PSD matrix by power iteration."""
    m = A.shape[0]
    v = torch.ones(m, dtype=A.dtype, device=A.device) / np.sqrt(m)
    for _ in range(iters):
        w = A @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return float(torch.linalg.vector_norm(A @ v))


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
    floors are ~1e-15 relative and never bind.
    """
    n, m = X.shape[0], Z.shape[0]
    dtype = X.dtype if dtype is None else dtype
    eps_blocks = torch.finfo(X.dtype).eps
    eps_dev = torch.finfo(dtype).eps
    eye = torch.eye(m, dtype=dtype, device=X.device)

    K_ZZ = block_fn(Z, Z).to(dtype)
    K_ZZ = 0.5 * (K_ZZ + K_ZZ.T)
    nu = f32_floor * eps_blocks * _lam1(K_ZZ)
    L = robust_cholesky(K_ZZ + nu * eye, jitter=0.0)
    del K_ZZ
    L_inv_T = torch.linalg.solve_triangular(L, eye, upper=False).T
    B = block_fn(X, Z).to(dtype) @ L_inv_T
    del L, L_inv_T
    C0 = B.T @ B
    C0 = 0.5 * (C0 + C0.T)
    lam1_c0 = _lam1(C0)

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
