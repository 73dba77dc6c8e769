"""Distributed gram-free conditioning: the N = 1e5 path over a mesh.

Port of ``linpde_gp_tpu/parallel/iterative.py``.  Every rank owns a
contiguous slab of the (padded) collocation points and produces its slice
of each Gram product with the same kernels as the single-card regressor
(``models/iterative.py``): K2 on its slab against all points (the banded
kernel for a compactly supported prior, on its own schedule), K1 for its
Nyström and variance cross blocks.  Per CG iteration that is one
``all_gather`` of the matvec (both planes of K2's ff pair in mode ff) and,
in the Woodbury apply, one ``all_reduce`` of an ``(m,)`` vector and one
``all_gather``.  The CG is the single-card one (``pcg_ff`` for the weights,
``pcg_block_ff`` for ``var``), with the sharded matvec and preconditioner as
its callables; its vectors are replicated and bitwise equal on every rank,
so every rank takes the same stopping decision.  At world size 1 this is
the single-card regressor's computation.

Two departures from the JAX package, both defects there:

- Its mesh CG is a plain PCG in the vectors' dtype that sums K2's
  compensated output in float32 (``iterative.py:376-467``), the arithmetic
  that cannot reach the true residual at N = 1e5 on one chip; here mode ff
  carries the ff pair through the gather into the ff CG, and the Nyström
  factors are float64.
- Its Nyström build picks between two Cholesky factors with
  ``where(isnan)`` and carries NaNs into the weights when both fail
  (``iterative.py:297-311``); here each factorization climbs its ladder
  through ``cholesky_ex`` and raises ``torch.linalg.LinAlgError`` when no
  rung holds.

For a Wendland prior the points are sorted along dimension 0 (stable, as
``iterative.py:180-187``) and each rank builds its own banded schedule of
its slab against all points (``ops/banded.make_banded_matvec``); the JAX
package takes the widest window over the devices so that every device runs
one program, which the ranks here do not need.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import mode_dtype, resolve_mode
from ..models.functions.base import Zero
from ..ops.banded import compact_support_radius, make_banded_matvec
from ..ops.ff import ff_split
from ..ops.gram import gram, gram_matrix, gram_matvec, kernel_term_specs
from ..ops.linalg.pcg import _as_ff, _lam1, landmark_indices, pcg_block_ff, pcg_ff
from ..ops.transforms.dispatch import apply_operator_to_kernel
from .mesh import Mesh


def _pad_rows(X: torch.Tensor, P: int) -> tuple[torch.Tensor, int]:
    """``X`` padded to a multiple of ``P`` rows by repeating its last row."""
    n = X.shape[0]
    n_pad = -(-n // P) * P
    if n_pad != n:
        X = torch.cat([X, X[-1:].expand(n_pad - n, X.shape[1])])
    return X, n_pad


def _points(X, mode: str, device) -> torch.Tensor:
    X = torch.as_tensor(X)
    X = X[:, None] if X.ndim == 1 else X.reshape(X.shape[0], -1)
    return X.to(device=device, dtype=mode_dtype(mode)).contiguous()


def _gather(out, mesh: Mesh):
    """All-gather a per-rank result: a tensor, or both planes of an ff pair."""
    if isinstance(out, tuple):
        return tuple(mesh.all_gather(o) for o in out)
    return mesh.all_gather(out)


def distributed_gram_matvec(spec, X0, X1, v, *, mesh: Mesh, mode=None, gather: bool = False):
    """``scale * K(X0, X1) @ v`` with the rows split over every rank
    (``iterative.py:59-99`` of the JAX package): each rank streams its slab
    of ``X0`` (padded to a multiple of the mesh size) against all of ``X1``
    through K2.  ``gather=False`` returns this rank's real rows (a slab of
    the result); ``gather=True`` the whole ``(n0,)`` / ``(n0, r)`` result on
    every rank.  Mode ff takes ``v`` or an ff pair and returns the ff pair
    ``(hi, lo)``."""
    mode = resolve_mode(mode)
    X0 = _points(X0, mode, mesh.device)
    X1 = _points(X1, mode, mesh.device)
    n0 = X0.shape[0]
    X0p, n_pad = _pad_rows(X0, mesh.size)
    n_loc = n_pad // mesh.size
    out = gram_matvec(spec, X0p[mesh.rank * n_loc:(mesh.rank + 1) * n_loc], X1, v, mode)
    if gather:
        out = _gather(out, mesh)
        return tuple(o[:n0] for o in out) if mode == "ff" else out[:n0]
    real = max(0, min(n_loc, n0 - mesh.rank * n_loc))
    return tuple(o[:real] for o in out) if mode == "ff" else out[:real]


class ShardedNystrom:
    """The Nyström preconditioner ``P = delta I + B B^T`` with ``B``
    row-sharded (``B_loc``: this rank's rows ``rows`` of it), applied by the
    Woodbury identity with one ``all_reduce`` of ``B^T r`` and one
    ``all_gather`` of ``B w``; takes and returns what
    ``ops/linalg/pcg.NystromPreconditioner`` does (a tensor, or an ff pair
    applied to ``hi + lo`` in the factors' wider precision)."""

    def __init__(self, B_loc: torch.Tensor, chol_C: torch.Tensor, delta: float, mesh: Mesh, rows: slice):
        self.B_loc, self.chol_C, self.delta, self.mesh, self.rows = B_loc, chol_C, float(delta), mesh, rows

    def __call__(self, r):
        pair = isinstance(r, tuple)
        r_dtype = r[0].dtype if pair else r.dtype
        dt = self.B_loc.dtype
        if pair and torch.finfo(dt).eps < torch.finfo(r_dtype).eps:
            rr = r[0].to(dt) + r[1].to(dt)
        else:
            rr = (r[0] if pair else r).to(dt)
        vector = rr.ndim == 1
        rr = rr[:, None] if vector else rr
        br = self.mesh.all_reduce(self.B_loc.T @ rr[self.rows])
        bw = self.mesh.all_gather(self.B_loc @ torch.cholesky_solve(br, self.chol_C))
        out = (rr - bw) / self.delta
        out = out[:, 0] if vector else out
        return _as_ff(out, r_dtype) if pair else out.to(r_dtype)


def _cholesky_ladder(A: torch.Tensor, shifts, what: str) -> tuple[torch.Tensor, float]:
    """The factor of ``A + s I`` at the first ``s`` of ``shifts`` that
    factors, and that ``s``; ``LinAlgError`` if none does."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    for s in shifts:
        L, info = torch.linalg.cholesky_ex(A + s * eye)
        if int(info) == 0:
            return L, s
    raise torch.linalg.LinAlgError(
        f"Nystrom build: {what} is not positive definite at shifts {[f'{s:.3g}' for s in shifts]} "
        f"(leading minor {int(info)})"
    )


class DistributedIterativeGPRegressor:
    """Gram-free GP conditioning with every O(N^2) stage split over a mesh
    (``iterative.py:102-670`` of the JAX package): the constructor of the
    single-card :class:`~linpde_gp_tpu_torch.models.iterative.
    IterativeGPRegressor` (prior, points, values, ``L=``, any prior mean,
    ``precond_rank``, ``mode=``) plus ``mesh=``; kernels of the
    sum-of-products family only.  Results are on every rank, on the
    mesh's device."""

    def __init__(self, prior, X, Y, *, mesh: Mesh, L=None, noise_variance: float = 1e-6, tol: float = 1e-6,
                 maxiter: int = 512, precond_rank: int | str = "auto", mode: str | None = None):
        if prior.output_shape != ():
            raise ValueError("DistributedIterativeGPRegressor supports scalar outputs.")
        k = prior.cov
        if L is not None:
            k_obs = apply_operator_to_kernel(L, apply_operator_to_kernel(L, k, argnum=1), argnum=0)
            k_cross = apply_operator_to_kernel(L, k, argnum=1)
            mean_obs = prior.mean if isinstance(prior.mean, Zero) else L(prior.mean)
        else:
            k_obs = k_cross = k
            mean_obs = prior.mean
        self._obs_spec, self._cross_spec = kernel_term_specs(k_obs), kernel_term_specs(k_cross)
        if self._obs_spec is None or self._cross_spec is None:
            raise ValueError("gram-free distributed conditioning needs the closed-form sum-of-products kernel "
                             "family (use the dense DistributedConditioner otherwise)")
        self.prior, self.mesh, self._k_cross, self._mean_obs = prior, mesh, k_cross, mean_obs
        self.mode = resolve_mode(mode)
        self.noise_variance, self.tol, self.maxiter = float(noise_variance), float(tol), int(maxiter)
        X = torch.as_tensor(X).reshape((-1,) + tuple(prior.input_shape))
        self.X = _points(X.reshape(X.shape[0], -1), self.mode, mesh.device)
        self.Y = torch.as_tensor(Y).reshape(-1).to(device=mesh.device, dtype=self.X.dtype)
        n = self.X.shape[0]
        if precond_rank == "auto":
            precond_rank = min(512, n // 4) if n >= 1024 else 0
        self.precond_rank = int(min(int(precond_rank), n))

        # Compact support along dimension 0: sort the points (caller's order
        # kept on every public surface) and give each rank its band.
        self._order = None
        x = self.X
        if compact_support_radius(self._obs_spec[1], 0) is not None:
            order = np.argsort(self.X[:, 0].to("cpu", torch.float64).numpy(), kind="stable")
            self._order = torch.as_tensor(order, device=mesh.device)
            self._inv_order = torch.as_tensor(np.argsort(order), device=mesh.device)
            x = self.X[self._order]
        self._x_sorted = x
        self._x_pad, self._n_pad = _pad_rows(x, mesh.size)
        n_loc = self._n_pad // mesh.size
        self._rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
        self._slab = self._x_pad[self._rows].contiguous()
        ids = torch.arange(self._n_pad, device=mesh.device)
        self._mask_full = (ids < n).to(self.X.dtype)
        self._mask_loc = self._mask_full[self._rows]
        self._banded = None
        if self._order is not None:
            banded = make_banded_matvec(self._obs_spec, self._slab, self._x_pad, mode=self.mode)
            if banded.band_tiles < banded.total_tiles:
                self._banded = banded
        self._precond = None
        self._weights = None
        self._solve_info = None
        self._var_info = None

    # -- pieces ------------------------------------------------------------------
    @property
    def _dtype(self) -> torch.dtype:
        """The dtype of the state past the points' precision (Nyström
        factors, residuals, the variance's quadratic form): float64 unless
        the mode is plain."""
        return torch.float32 if self.mode == "plain" else torch.float64

    def _local_mv(self, v):
        """This rank's slab of the unshifted Gram product (K2 or banded):
        an ff pair in mode ff, else a tensor."""
        if self._banded is not None:
            return self._banded(v)
        return gram_matvec(self._obs_spec, self._slab, self._x_pad, v, self.mode)

    def _matvec(self, v_ff):
        """The CG's unshifted operator on the replicated, padded ff pair
        ``v_ff``: the padding's columns and rows masked out (a decoupled
        ``sigma^2 I`` block, so zero-padded right-hand sides stay zero
        there), each rank's slab gathered; mode ff gathers both planes."""
        mask = self._mask_full if v_ff[0].ndim == 1 else self._mask_full[:, None]
        mask_loc = self._mask_loc if v_ff[0].ndim == 1 else self._mask_loc[:, None]
        out = self._local_mv((v_ff[0] * mask, v_ff[1] * mask) if self.mode == "ff" else v_ff[0] * mask)
        out = tuple(o * mask_loc for o in out) if isinstance(out, tuple) else out * mask_loc
        return _gather(out, self.mesh)

    def _block(self, x0, x1) -> torch.Tensor:
        """Observation-kernel block through K1, in the mode's dtype."""
        scale, terms = self._obs_spec
        out = gram(terms, x0, x1, self.mode)
        return scale * out if scale != 1.0 else out

    def _preconditioner(self):
        """The sharded Nyström preconditioner (``None`` at rank 0), built
        once (``iterative.py:250-322`` of the JAX package): ``K_ZZ``
        replicated, stabilized at ``8 eps lambda_1`` (``eps`` of the blocks'
        dtype; 100x if that fails), ``B`` row-sharded, ``C0 = B^T B`` by one
        ``all_reduce``, the damping ``delta = max(lambda_min(C0), 8 eps
        lambda_max(C0)) + sigma^2`` by ``eigvalsh`` (10x if ``C0 + delta
        I`` fails); factors in float64 unless the mode is plain."""
        if self.precond_rank <= 0:
            return None
        if self._precond is None:
            dt = self._dtype
            n, m = self.X.shape[0], self.precond_rank
            Z = self._x_sorted[landmark_indices(n, m, device=self.mesh.device)]
            K_zz = self._block(Z, Z).to(dt)
            K_zz = 0.5 * (K_zz + K_zz.T)
            stab = 8.0 * torch.finfo(self.X.dtype).eps * _lam1(K_zz)
            L_zz, _ = _cholesky_ladder(K_zz, (stab, 100.0 * stab), "K_ZZ")
            K_xz = self._block(self._slab, Z).to(dt) * self._mask_loc.to(dt)[:, None]
            B_loc = torch.linalg.solve_triangular(L_zz.T, K_xz, upper=True, left=False)
            C0 = self.mesh.all_reduce(B_loc.T @ B_loc)
            C0 = 0.5 * (C0 + C0.T)
            lam = torch.linalg.eigvalsh(C0)
            eps = torch.finfo(dt).eps
            delta = max(float(lam[0]), 8.0 * eps * max(float(lam[-1]), 0.0)) + self.noise_variance
            chol_C, delta = _cholesky_ladder(C0, (delta, 10.0 * delta), "C0 + delta I")
            self._precond = ShardedNystrom(B_loc, chol_C, delta, self.mesh, self._rows)
        return self._precond

    def _mean_at(self, f, X) -> torch.Tensor | None:
        """``f`` at stored ``(n, d)`` points in float64, returned in
        :attr:`_dtype` (``None`` for a zero mean)."""
        if f is None or isinstance(f, Zero):
            return None
        vals = f(X.double().reshape((-1,) + tuple(self.prior.input_shape)))
        return vals.reshape(-1).to(self._dtype)

    # -- solve ---------------------------------------------------------------------
    def _weights_ff(self):
        """The weights as the CG's ff pair, in the caller's point order."""
        if self._weights is None:
            n = self.X.shape[0]
            resid = self.Y.to(self._dtype)
            m_obs = self._mean_at(self._mean_obs, self.X)
            if m_obs is not None:
                resid = resid - m_obs
            if self._order is not None:
                resid = resid[self._order]
            b = resid.new_zeros(self._n_pad)
            b[:n] = resid
            rhs = ff_split(b.double(), self.X.dtype) if self.mode == "ff" else b.to(self.X.dtype)
            res = pcg_ff(self._matvec, self._preconditioner(), rhs, self.noise_variance, tol=self.tol,
                         maxiter=self.maxiter)
            self._solve_info = (res.iterations, res.relative_residual)
            w = (res.x[:n], res.x_lo[:n])
            if self._order is not None:
                w = (w[0][self._inv_order], w[1][self._inv_order])
            self._weights = w
        return self._weights

    @property
    def representer_weights(self) -> torch.Tensor:
        """``(K + sigma^2 I)^{-1} (Y - (L m)(X))`` in the caller's order;
        mode ff returns ``hi + lo`` in float64, the other modes their dtype."""
        hi, lo = self._weights_ff()
        return hi.double() + lo.double() if self.mode == "ff" else hi

    @property
    def solve_info(self):
        """``(iterations, relative_residual)`` of the solve."""
        return self._solve_info

    @property
    def var_info(self):
        """``[(iterations, relative_residual), ...]`` of the last ``var``'s blocks."""
        return self._var_info

    def _queries(self, x) -> tuple[torch.Tensor, tuple]:
        x = torch.as_tensor(x)
        batch = tuple(x.shape[: x.ndim - len(self.prior.input_shape)])
        return _points(x.reshape((-1,) + tuple(self.prior.input_shape)).reshape(-1, self.X.shape[1]), self.mode,
                       self.mesh.device), batch

    def mean(self, x) -> torch.Tensor:
        """Posterior mean ``m(xq) + (k L*)(xq, X) w`` at ``batch +
        input_shape`` queries, the query rows split over the mesh
        (:func:`distributed_gram_matvec`, gathered); in the mode's dtype."""
        xq, batch = self._queries(x)
        w = self._weights_ff()
        mu = distributed_gram_matvec(self._cross_spec, xq, self.X, w if self.mode == "ff" else w[0],
                                     mesh=self.mesh, mode=self.mode, gather=True)
        mu = mu[0].double() + mu[1].double() if self.mode == "ff" else mu
        m = self._mean_at(self.prior.mean, xq)
        if m is not None:
            mu = mu.to(m) + m
        return mu.to(self.X.dtype).reshape(batch)

    def var(self, x, *, block_size: int = 256, tol: float | None = None) -> torch.Tensor:
        """Posterior variance at ``batch + input_shape`` queries, per block
        of ``block_size`` queries (``iterative.py:470-670`` of the JAX
        package): each rank's rows of ``kxX`` by K1 (float64 unless plain),
        one ``all_gather``, the blocked ff CG (``pcg_block_ff``) through the
        sharded multi-column matvec, the quadratic form, ``max(prior_var -
        update, 0)``.  Modes ff and f64 return float64."""
        xq, batch = self._queries(x)
        dt = self._dtype
        kx_mode = "plain" if self.mode == "plain" else "f64"
        M = self._preconditioner()
        updates, info = [], []
        for s in range(0, xq.shape[0], int(block_size)):
            xb = xq[s:s + int(block_size)]
            U = gram_matrix(self._k_cross, xb.to(dt), self._slab.to(dt), kx_mode).T * self._mask_loc.to(dt)[:, None]
            U = self.mesh.all_gather(U.contiguous())
            rhs = ff_split(U, self.X.dtype) if U.dtype != self.X.dtype else U
            res = pcg_block_ff(self._matvec, M, rhs, self.noise_variance, tol=self.tol if tol is None else tol,
                               maxiter=self.maxiter)
            info.append((res.iterations, res.relative_residual))
            updates.append(torch.sum(U * (res.x.to(dt) + res.x_lo.to(dt)), 0))
        self._var_info = info
        prior_var = self.prior.cov(xq.to(dt).reshape((-1,) + tuple(self.prior.input_shape)))
        return torch.clamp(prior_var - torch.cat(updates), min=0.0).reshape(batch)

    def std(self, x, **kw) -> torch.Tensor:
        return torch.sqrt(self.var(x, **kw))
