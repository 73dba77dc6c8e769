"""One-shot and incremental distributed conditioning: the Gram rows each
rank needs, the distributed Cholesky, distributed solves.

Port of ``linpde_gp_tpu/parallel/solve.py``.  Where the JAX package forms
the sharded Gram, then ``gram + diag * eye``, then a padded identity copy
(three n x n arrays: ~26 GB in float64 at N = 32,768), each rank here
evaluates only the rows its factorization layout gives it (:class:`GramRows`,
through K1 on the card), adds the diagonal there in place, and pads only
when ``n`` does not divide: the padded Gram is ``blockdiag(K, I)``, whose
factor is ``blockdiag(chol(K), I)``, and zero-padded right-hand sides stay
zero through both triangular solves.
"""

from __future__ import annotations

import torch

from ..config import config
from ..ops.gram import gram_matrix
from .cholesky import (
    BlockRows,
    _size,
    distributed_chol_solve,
    distributed_cholesky,
    distributed_cholesky_2d,
    distributed_cholesky_cyclic,
)
from .extend import DistributedCholFactor
from .gram import points
from .mesh import Mesh

LAYOUTS = ("auto", "2d", "cyclic", "contiguous")


def _pad_multiple(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


class GramRows:
    """The entries of ``blockdiag(k(X, X) + bump I, I)`` (size ``n``, the
    padded size) for index sets: ``self(rows, cols)`` evaluates the real
    block by ``gram_matrix`` (K1 on CUDA tensors) in float64, adds ``bump``
    where a row meets its column, and sets the padding's identity."""

    def __init__(self, kernel, X: torch.Tensor, n: int, bump: float):
        self.kernel, self.X, self.n, self.bump = kernel, X, int(n), float(bump)

    def __call__(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        n_real = self.X.shape[0]
        r_real, c_real = rows < n_real, cols < n_real
        if bool(r_real.all()) and bool(c_real.all()):
            out = gram_matrix(self.kernel, self.X[rows], self.X[cols], "f64")
        else:
            out = torch.zeros((rows.shape[0], cols.shape[0]), dtype=torch.float64, device=self.X.device)
            ri, ci = torch.nonzero(r_real)[:, 0], torch.nonzero(c_real)[:, 0]
            if ri.numel() and ci.numel():
                out[ri[:, None], ci[None, :]] = gram_matrix(self.kernel, self.X[rows[ri]], self.X[cols[ci]], "f64")
        # Diagonal entries: cols is ascending, so each row finds its column by search.
        j = torch.searchsorted(cols, rows).clamp(max=cols.shape[0] - 1)
        on = cols[j] == rows
        i = torch.nonzero(on)[:, 0]
        real = rows[i] < n_real
        out[i, j[i]] += torch.where(real, torch.full_like(real, self.bump, dtype=out.dtype),
                                    torch.ones_like(real, dtype=out.dtype))
        return out


def _factorize(gram, *, mesh: Mesh, block_size: int, layout: str = "auto") -> BlockRows:
    """Route the distributed factorization (``solve.py:26-64`` of the JAX
    package): ``"auto"`` takes the 2-D block-cyclic layout on 2-D meshes of
    P >= 4 ranks with ``Pr | Pc`` when ``n`` divides, else the 1-D cyclic
    one; ``"2d"``, ``"cyclic"`` or ``"contiguous"`` force one.  The JAX
    package takes the contiguous layout above 128 block-columns, where its
    unrolled cyclic program would take too long to compile; nothing is
    compiled here, so ``"auto"`` stays cyclic at any size.  ``gram``: a full
    matrix or a :class:`GramRows`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    n, nb, names = _size(gram), int(block_size), mesh.axis_names
    if layout == "auto":
        two_d = (len(names) == 2 and mesh.size >= 4 and mesh.shape[names[1]] % mesh.shape[names[0]] == 0
                 and n % (nb * mesh.shape[names[1]]) == 0)
        layout = "2d" if two_d else "cyclic"
    if layout == "2d":
        return distributed_cholesky_2d(gram, mesh=mesh, block_size=nb)
    if layout == "cyclic":
        return distributed_cholesky_cyclic(gram, mesh=mesh, block_size=nb)
    return distributed_cholesky(gram, mesh=mesh, block_size=nb)


def _gram_rows(kernel, X, mesh: Mesh, block_size: int, noise_variance: float, jitter: float | None):
    X = points(kernel, X, mesh.device)
    n = X.shape[0]
    quantum = mesh.size * int(block_size)
    n_pad = _pad_multiple(max(n, quantum), quantum)
    bump = float(noise_variance) + (config.cholesky_jitter if jitter is None else float(jitter))
    return X, n, n_pad, GramRows(kernel, X, n_pad, bump)


def distributed_condition(kernel, X, Y, *, mesh: Mesh, noise_variance: float = 0.0, block_size: int = 256,
                          jitter: float | None = None, layout: str = "auto"):
    """Representer weights ``(K + (sigma^2 + jitter) I)^{-1} Y`` with every
    stage distributed (``solve.py:67-111`` of the JAX package): each rank's
    Gram rows, the distributed factorization (:func:`_factorize`, which
    also adds ``config.cholesky_jitter`` relative to the mean diagonal),
    the distributed solve.  ``jitter``: absolute, ``None`` meaning
    ``config.cholesky_jitter``.  Returns ``(weights, chol)``: the ``(n,)``
    weights on every rank and the factor (padded size)."""
    X, n, n_pad, rows = _gram_rows(kernel, X, mesh, block_size, noise_variance, jitter)
    Yp = torch.zeros(n_pad, dtype=torch.float64, device=mesh.device)
    Yp[:n] = torch.as_tensor(Y, dtype=torch.float64).reshape(-1).to(mesh.device)
    chol = _factorize(rows, mesh=mesh, block_size=block_size, layout=layout)
    return distributed_chol_solve(chol, Yp, mesh=mesh)[:n], chol


class DistributedConditioner:
    """Incremental distributed GP conditioning (``solve.py:114-294`` of the
    JAX package): the base Gram is factored once over the mesh; each further
    observation batch is a Schur extension (:class:`DistributedCholFactor`).
    Batches may use different operator-transformed kernels: per new batch
    the caller passes the cross kernel against each earlier batch (``L_i k
    L_new*``) and the new diagonal kernel (``L_new k L_new*``).  The
    extension blocks are evaluated whole on every rank (batches are small)."""

    def __init__(self, *, mesh: Mesh, block_size: int = 256):
        self.mesh = mesh
        self.block_size = int(block_size)
        self._factor: DistributedCholFactor | None = None
        self._Xs: list[torch.Tensor] = []
        self._resids: list[torch.Tensor] = []
        self._n_pad = 0
        self._n0 = 0

    @property
    def num_batches(self) -> int:
        return len(self._Xs)

    def condition(self, kernel, X, Y, *, noise_variance: float = 0.0, jitter: float | None = None,
                  layout: str = "auto") -> torch.Tensor:
        """Factor the first (large) batch; returns its representer weights."""
        if self._factor is not None:
            raise RuntimeError("already conditioned; use extend()")
        X, n, n_pad, rows = _gram_rows(kernel, X, self.mesh, self.block_size, noise_variance, jitter)
        chol = _factorize(rows, mesh=self.mesh, block_size=self.block_size, layout=layout)
        self._factor = DistributedCholFactor(chol, mesh=self.mesh)
        self._Xs = [X]
        self._n0, self._n_pad = n, n_pad
        resid = torch.zeros(n_pad, dtype=torch.float64, device=self.mesh.device)
        resid[:n] = torch.as_tensor(Y, dtype=torch.float64).reshape(-1).to(self.mesh.device)
        self._resids = [resid]
        return self.weights()

    def _padded(self, i: int, C: torch.Tensor) -> torch.Tensor:
        """Block ``C`` of batch ``i``'s rows in the factor's row layout (the
        base batch's padding rows zero)."""
        if i == 0 and self._n_pad != self._n0:
            C = torch.cat([C, C.new_zeros((self._n_pad - self._n0, C.shape[1]))])
        return C

    def extend(self, cross_kernels, diag_kernel, X_new, Y_new, *, noise_variance: float = 0.0,
               jitter: float | None = None) -> torch.Tensor:
        """Append an observation batch without refactoring; returns the
        weights of every batch.  ``cross_kernels``: one kernel per existing
        batch, evaluating ``L_i k L_new*``; ``diag_kernel``: ``L_new k
        L_new*``."""
        if self._factor is None:
            raise RuntimeError("call condition() first")
        X_new = points(diag_kernel, X_new, self.mesh.device)
        Y_new = torch.as_tensor(Y_new, dtype=torch.float64).reshape(-1).to(self.mesh.device)
        B = torch.cat([self._padded(i, gram_matrix(k, X_old, X_new, "f64"))
                       for i, (k, X_old) in enumerate(zip(cross_kernels, self._Xs))])
        D = gram_matrix(diag_kernel, X_new, X_new, "f64")
        bump = float(noise_variance) + (config.cholesky_jitter if jitter is None else float(jitter))
        if bump:
            D.diagonal().add_(bump)
        self._factor.extend(B, D)
        self._Xs.append(X_new)
        self._resids.append(Y_new)
        return self.weights()

    def weights(self) -> torch.Tensor:
        """Representer weights of all batches (padding rows stripped)."""
        w = self._weights_full()
        return torch.cat([w[: self._n0], w[self._n_pad:]])

    def _weights_full(self) -> torch.Tensor:
        return self._factor.solve(torch.cat(self._resids))

    def posterior_eval(self, cross_kernels, prior_kernel, Xq, *, with_std: bool = True,
                       query_block_size: int = 1024):
        """Posterior mean (and std) at query points against the distributed
        factor: per block of queries, the cross block ``U`` (one per batch,
        ``k_i(X_i, xq)``) evaluated whole on every rank, the mean ``U^T w``,
        and for the std the multi-RHS distributed forward solve ``L y = U``
        (``posterior.py`` analogue, ``solve.py:225-294`` of the JAX package).
        ``prior_kernel``: the prior kernel (pointwise variance); zero prior
        mean assumed.  Returns tensors on the mesh's device."""
        if self._factor is None:
            raise RuntimeError("call condition() first")
        Xq = points(prior_kernel, Xq, self.mesh.device)
        w = self._weights_full()
        bq = max(1, min(int(query_block_size), Xq.shape[0]))
        means, stds = [], []
        for s in range(0, Xq.shape[0], bq):
            xb = Xq[s:s + bq]
            U = torch.cat([self._padded(i, gram_matrix(k, X_i, xb, "f64"))
                           for i, (k, X_i) in enumerate(zip(cross_kernels, self._Xs))])
            means.append(U.T @ w)
            if with_std:
                y = self._factor._solve_lower(U)
                prior_var = prior_kernel(xb.reshape((-1,) + tuple(prior_kernel.input_shape)))
                stds.append(torch.sqrt(torch.clamp(prior_var.reshape(-1) - torch.sum(y * y, 0), min=0.0)))
        mean = torch.cat(means)
        return (mean, torch.cat(stds)) if with_std else mean
