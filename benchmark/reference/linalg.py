"""Plain PyTorch posterior algebra of the reference, for any covariance form
``fn(x0, x1)`` (no kernels of the port): blocks of rows, a block-triangle
operator, a Nystrom-preconditioned CG and the dense posterior.  Everything is
evaluated in the dtype of the points in blocks of rows, so that a 1e5 x 1e5
operator never has to exist at once.
"""

from __future__ import annotations

import torch

#: Rows of a kernel block evaluated at once (temporaries of ROWS x n1).
ROWS = 1024


def block_matrix(fn, x0, x1, out=None, rows: int = ROWS):
    """``fn(x0, x1)`` formed a block of rows at a time (into ``out`` if given)."""
    if out is None:
        out = torch.empty((x0.shape[0], x1.shape[0]), dtype=x0.dtype, device=x0.device)
    for s in range(0, x0.shape[0], rows):
        out[s:s + rows] = fn(x0[s:s + rows], x1)
    return out


def block_matvec(fn, x0, x1, v, rows: int = ROWS):
    """``fn(x0, x1) @ v`` (``v``: ``(n1,)`` or ``(n1, r)``) a block of rows at a time."""
    out = torch.empty((x0.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    for s in range(0, x0.shape[0], rows):
        out[s:s + rows] = fn(x0[s:s + rows], x1) @ v
    return out


class SymmetricOperator:
    """``K(X, X) + shift I`` for a symmetric form, its lower block triangle
    kept (row block ``I`` holds ``K[I, :end_I]``): about half of the
    matrix, so that 1e5 points fit in float64 (41.6 GB) and each product
    reads it instead of evaluating 1e10 pairs again."""

    def __init__(self, fn, x, shift: float, block: int = 4096):
        self.n, self.shift, self.block = x.shape[0], float(shift), block
        self.rows = []
        for s in range(0, self.n, block):
            e = min(s + block, self.n)
            self.rows.append(block_matrix(fn, x[s:e], x[:e]))

    def __matmul__(self, v):
        out = self.shift * v
        b = self.block
        for i, R in enumerate(self.rows):
            s, e = i * b, i * b + R.shape[0]
            out[s:e] += R @ v[:e]
            if s:
                out[:s] += R[:, :s].T @ v[s:e]
        return out


class Nystrom:
    """``(U U^T + shift I)^{-1}`` by Woodbury, ``U = K(X, Z) chol(K(Z, Z))^{-T}``
    with ``Z`` the first ``m`` points (the points are drawn independently,
    so they are a uniform sample)."""

    def __init__(self, fn, x, m: int, shift: float):
        z = x[:m]
        kzz = fn(z, z)
        jitter = 1e-12 * float(torch.diagonal(kzz).mean())
        L = torch.linalg.cholesky(kzz + jitter * torch.eye(m, dtype=x.dtype, device=x.device))
        U = block_matrix(fn, x, z)
        self.U = torch.linalg.solve_triangular(L, U.T, upper=False).T.contiguous()
        C = self.U.T @ self.U
        C.diagonal().add_(shift)
        self.C = torch.linalg.cholesky(C)
        self.shift = float(shift)

    def __call__(self, r):
        return (r - self.U @ torch.cholesky_solve(self.U.T @ r, self.C)) / self.shift


def pcg(A, b, M, tol: float, maxiter: int):
    """Preconditioned CG on the columns of ``b`` (``(n, r)``), each stopped
    when its residual is below ``tol`` of its right-hand side; returns the
    solution and the iterations."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = (r * z).sum(0)
    bn = b.norm(dim=0)
    for k in range(1, maxiter + 1):
        Ap = A @ p
        alpha = rz / (p * Ap).sum(0)
        x += alpha * p
        r -= alpha * Ap
        if bool((r.norm(dim=0) <= tol * bn).all()):
            return x, k
        z = M(r)
        rz_new = (r * z).sum(0)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter


def cholesky_ladder(G):
    """Lower factor of ``G`` in its dtype, retrying with a jitter of eps,
    100 eps, ... of the mean diagonal where the factorization fails; the
    float32 control needs it, a float64 factor of these matrices never."""
    L, info = torch.linalg.cholesky_ex(G)
    eps = torch.finfo(G.dtype).eps
    scale, rel = float(torch.diagonal(G).mean()), eps
    while int(info) != 0 and rel < 1e7 * eps:
        H = G.clone()
        H.diagonal().add_(rel * scale)
        L, info = torch.linalg.cholesky_ex(H)
        rel *= 100.0
    if int(info) != 0:
        raise torch.linalg.LinAlgError(f"reference Cholesky failed (leading minor {int(info)})")
    return L


class DensePosterior:
    """The exact posterior of ``u`` given point values at ``xa`` (noise
    ``anchor_noise``) and ``Hu`` at ``x`` (noise ``noise``): one Cholesky of
    the joint Gram in the points' dtype."""

    def __init__(self, kern, x, xa, ya, y, noise: float, anchor_noise: float):
        na, n = xa.shape[0], x.shape[0]
        self.kern, self.x, self.xa = kern, x, xa
        G = torch.empty((na + n, na + n), dtype=x.dtype, device=x.device)
        G[:na, :na] = kern.k(xa, xa)
        block_matrix(kern.k_hs, xa, x, out=G[:na, na:])
        G[na:, :na] = G[:na, na:].T
        block_matrix(kern.hk_hs, x, x, out=G[na:, na:])
        G.diagonal()[:na] += anchor_noise
        G.diagonal()[na:] += noise
        self.L = cholesky_ladder(G)
        del G
        rhs = torch.cat([ya, y]).to(x.dtype)[:, None]
        self.w = torch.cholesky_solve(rhs, self.L)[:, 0]

    def cross(self, xq):
        """``(nq, na + n)`` covariances of ``u(xq)`` with the observations."""
        return torch.cat([self.kern.k(xq, self.xa), block_matrix(self.kern.k_hs, xq, self.x)], 1)

    def mean(self, xq):
        return self.cross(xq) @ self.w

    def std(self, xq):
        q = torch.linalg.solve_triangular(self.L, self.cross(xq).T, upper=False)
        return torch.sqrt(torch.clamp(self.kern.k_diag(xq) - (q * q).sum(0), min=0.0))
