"""Distributed gram-free conditioning: the N = 1e5 path over a mesh.

Port of ``linpde_gp_tpu/parallel/iterative.py``.  Every rank owns a
contiguous slab of the (padded) collocation points and produces its slice
of each Gram product with the same kernels as the single-card regressor
(``models/iterative.py``): K2 on its slab against all points (the banded
kernel for a compactly supported prior, on its own schedule), K1 for its
Nyström and variance cross blocks.  Per CG iteration that is one
``all_gather`` of the matvec (both planes of K2's ff pair in mode ff) and,
in the Woodbury apply, one ``all_reduce`` of an ``(m,)`` vector and one
``all_gather``.  The regressor runs the single-card one's code
(``models/iterative.py::GramFreeCore``: ``pcg_ff`` for the weights,
``pcg_block_ff`` for ``var``), with the sharded matvec and preconditioner as
the CG's callables; its vectors are replicated and bitwise equal on every rank,
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
from ..models.iterative import GramFreeCore
from ..ops.banded import compact_support_radius, make_banded_matvec
from ..ops.ff import aux_mode, operand, planewise, read_back
from ..ops.gram import gram_matrix, gram_matvec, kernel_term_specs
from ..ops.linalg.pcg import lam1, landmark_indices, woodbury_apply
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
        return planewise(lambda o: o[:n0], planewise(mesh.all_gather, out))
    real = max(0, min(n_loc, n0 - mesh.rank * n_loc))
    return planewise(lambda o: o[:real], out)


class ShardedNystrom:
    """The Nyström preconditioner ``P = delta I + B B^T`` with ``B``
    row-sharded (``B_loc``: this rank's rows ``rows`` of it), applied by the
    Woodbury identity with one ``all_reduce`` of ``B^T r`` and one
    ``all_gather`` of ``B w``; takes and returns what
    ``ops/linalg/pcg.NystromPreconditioner`` does (``woodbury_apply``)."""

    def __init__(self, B_loc: torch.Tensor, chol_C: torch.Tensor, delta: float, mesh: Mesh, rows: slice):
        self.B_loc, self.chol_C, self.delta, self.mesh, self.rows = B_loc, chol_C, float(delta), mesh, rows

    def __call__(self, r):
        return woodbury_apply(r, self.B_loc.dtype, self._apply)

    def _apply(self, rr):
        br = self.mesh.all_reduce(self.B_loc.T @ rr[self.rows])
        return (rr - self.mesh.all_gather(self.B_loc @ torch.cholesky_solve(br, self.chol_C))) / self.delta


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


class DistributedIterativeGPRegressor(GramFreeCore):
    """Gram-free GP conditioning with every O(N^2) stage split over a mesh
    (``iterative.py:102-670`` of the JAX package): the constructor of the
    single-card :class:`~linpde_gp_tpu_torch.models.iterative.
    IterativeGPRegressor` (prior, points, values, ``L=``, any prior mean,
    ``precond_rank``, ``mode=``) plus ``mesh=``; kernels of the
    sum-of-products family only.  It runs that regressor's code
    (:class:`~linpde_gp_tpu_torch.models.iterative.GramFreeCore`) and
    supplies the padded, sorted layout, the sharded matvec, the sharded
    Nyström build and the row-split mean and ``kxX``.  Results are on every
    rank, on the mesh's device."""

    def __init__(self, prior, X, Y, *, mesh: Mesh, L=None, noise_variance: float = 1e-6, tol: float = 1e-6,
                 maxiter: int = 512, precond_rank: int | str = "auto", mode: str | None = None):
        k_obs, self._k_cross, self._mean_obs = self._kernels(prior, L)
        self._obs_spec, self._cross_spec = kernel_term_specs(k_obs), kernel_term_specs(self._k_cross)
        if self._obs_spec is None or self._cross_spec is None:
            raise ValueError("gram-free distributed conditioning needs the closed-form sum-of-products kernel "
                             "family (use the dense DistributedConditioner otherwise)")
        self.prior, self.mesh = prior, mesh
        X = torch.as_tensor(X).reshape((-1,) + tuple(prior.input_shape))
        self._setup_core(X, Y, noise_variance, tol, maxiter, precond_rank, mode, mesh.device)
        n = self.X.shape[0]

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

    # -- the layout, the operator and the preconditioner -------------------------
    def _to_layout(self, v):
        """``v`` in sorted order, zero-padded to ``_n_pad`` rows."""
        if self._order is not None:
            v = v[self._order]
        b = v.new_zeros(self._n_pad)
        b[:v.shape[0]] = v
        return b

    def _from_layout(self, x):
        """The padded, sorted solution pair back in the caller's order."""
        n = self.X.shape[0]
        return planewise(lambda p: p[:n] if self._order is None else p[:n][self._inv_order], x)

    def _local_mv(self, v):
        """This rank's slab of the unshifted Gram product (K2 or banded):
        an ff pair in mode ff, else a tensor."""
        if self._banded is not None:
            return self._banded(v)
        return gram_matvec(self._obs_spec, self._slab, self._x_pad, v, self.mode)

    def _cg_matvec(self, v_ff):
        """The CG's unshifted operator on the replicated, padded ff pair
        ``v_ff``: the padding's columns and rows masked out (a decoupled
        ``sigma^2 I`` block, so zero-padded right-hand sides stay zero
        there), each rank's slab gathered; mode ff gathers both planes."""
        mask = self._mask_full if v_ff[0].ndim == 1 else self._mask_full[:, None]
        mask_loc = self._mask_loc if v_ff[0].ndim == 1 else self._mask_loc[:, None]
        out = self._local_mv(planewise(lambda v: v * mask, operand(v_ff, self.mode)))
        return planewise(self.mesh.all_gather, planewise(lambda o: o * mask_loc, out))

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
            K_zz = self._obs_block(Z, Z).to(dt)
            K_zz = 0.5 * (K_zz + K_zz.T)
            stab = 8.0 * torch.finfo(self.X.dtype).eps * lam1(K_zz)
            L_zz, _ = _cholesky_ladder(K_zz, (stab, 100.0 * stab), "K_ZZ")
            K_xz = self._obs_block(self._slab, Z).to(dt) * self._mask_loc.to(dt)[:, None]
            B_loc = torch.linalg.solve_triangular(L_zz.T, K_xz, upper=True, left=False)
            C0 = self.mesh.all_reduce(B_loc.T @ B_loc)
            C0 = 0.5 * (C0 + C0.T)
            lam = torch.linalg.eigvalsh(C0)
            eps = torch.finfo(dt).eps
            delta = max(float(lam[0]), 8.0 * eps * max(float(lam[-1]), 0.0)) + self.noise_variance
            chol_C, delta = _cholesky_ladder(C0, (delta, 10.0 * delta), "C0 + delta I")
            self._precond = ShardedNystrom(B_loc, chol_C, delta, self.mesh, self._rows)
        return self._precond

    # -- the mean's cross matvec and var's kxX, their rows split over the mesh ----
    def _cross_matvec(self, xq, w):
        """``(k L*)(xq, X) @ w``, the query rows split over the mesh
        (:func:`distributed_gram_matvec`, gathered), in float64 (plain:
        float32)."""
        out = distributed_gram_matvec(self._cross_spec, xq, self.X, operand(w, self.mode), mesh=self.mesh,
                                      mode=self.mode, gather=True)
        return read_back(out, self.mode)

    def _kx_rows(self, xb):
        """``kxX^T`` in the CG's padded, sorted rows: this rank's by K1 in
        the auxiliary mode (the padding's zeroed), gathered."""
        dt = self._dtype
        U = gram_matrix(self._k_cross, xb.to(dt), self._slab.to(dt), aux_mode(self.mode)).T
        return self.mesh.all_gather((U * self._mask_loc.to(dt)[:, None]).contiguous())
