"""Gram-free iterative GP conditioning (streaming path).

Port of the streaming path of ``linpde_gp_tpu/models/iterative.py``:
representer weights by float-float preconditioned CG
(``ops/linalg/pcg.pcg_ff``) whose every Gram matvec streams through K2
(``ops/gram.gram_matvec``) without storing the Gram, preconditioned by
the floored all-device Nyström build whose kernel blocks come from K1
(``ops/gram.gram``).  The posterior mean is one cross-kernel K2 matvec.

The regressor takes a prior and an optional linear operator ``L``, as the
JAX package's does, and derives the observation kernel ``L k L*`` and the
cross kernel ``k L*`` as ``(scale, terms)`` specs through the symbolic
layer (``ops/transforms``, ``ops/gram.kernel_term_specs``);
:meth:`IterativeGPRegressor.from_specs` takes the two specs directly.  A
compactly supported observation kernel (Wendland along dimension 0)
routes the CG matvec through the banded kernel (``ops/banded.py``)
whenever its band skips column tiles; the mean stays on dense K2, as in
the JAX package.

A small second batch of point observations ``u(X1) + eps`` (initial and
boundary values: the anchors) is conditioned jointly with the operator
batch by block elimination: CG runs on the Schur complement ``S = A22 -
W A11^{-1} W^T`` with ``A22 = L k L* + sigma^2 I``, ``W = (L k)(X, X1)``
and ``A11 = k(X1, X1) + anchor_noise I``.  The posterior variance solves
blocks of query columns by blocked ff CG (``pcg_block_ff``), one shared
K2 (or banded) launch of the multi-column route per iteration.

The prior mean ``m`` may be any function (``iterative.py:177-184``,
``:518-523``, ``:552`` of the JAX package): the CG solves for the residual
``Y - (L m)(X)`` (the anchors for ``Y1 - m(X1)``) and the mean adds
``m(xq)``.  A kernel without a sum-of-products spec (radial, autodiff,
general-``nu`` Matérn) takes its dense Gram ``gram_matrix(k_obs, X)`` in
the CG matvec and ``gram_matrix(k_cross, xq, X)`` in the mean
(``iterative.py:425-432``, ``:536-545`` there), evaluated once by its own
``_evaluate`` in float64 and kept.

Grid mode (``iterative.py:189-225`` of the JAX package): collocation
points given as a ``TensorProductGrid`` of two or more factors make the
observation Gram a sum of Kronecker products of small factor tables, and
the CG matvec (of the solve and of ``var``'s blocked CG) takes O(N (n_1 +
... + n_d)) instead of K2's O(N^2): the Kronecker operator of
:func:`~ops.kron_ff.kron_linop`, in float64 (plain: float32), whose
product mode ff splits into the CG's ff pair.  The JAX package takes the
compensated :class:`~ops.kron_ff.KronFFMatvec` in mode ff on 2-factor
grids; its float32 sums inside each chunk left the grid variance 1.6e-4 of
max var off float64's on an H100, where the float64 operator is exact and
faster (PERF.md).  The
Nyström build, the anchor blocks, the mean and ``var``'s ``kxX`` stay on
K1 and K2 at the flattened grid points (C order, row ``t * n_x + x``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import mode_dtype, resolve_device, resolve_mode
from ..ops.banded import compact_support_radius, make_banded_matvec
from ..ops.ff import ff_split
from ..ops.gram import gram, gram_matrix, gram_matvec, kernel_term_specs
from ..ops.kron_ff import kron_linop
from ..ops.linalg.chol import cho_solve, cholesky
from ..ops.linalg.pcg import landmark_indices, nystrom_preconditioner_device, pcg_block_ff, pcg_ff
from ..ops.transforms.dispatch import apply_operator_to_kernel
from ..utils.profiling import span
from ..utils.shapes import size
from .domains.grid import grid_factors
from .functions.base import Zero
from .gp import GaussianProcess


class IterativeGPRegressor:
    """Condition a scalar GP on one operator-observation set, gram-free,
    optionally jointly with a small anchor batch.

    >>> import numpy as np
    >>> import linpde_gp_tpu_torch as lgt
    >>> prior = lgt.GaussianProcess(
    ...     lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5), device="cpu")
    >>> X = np.linspace(-1.0, 1.0, 32)
    >>> reg = IterativeGPRegressor(prior, X, np.sin(3.0 * X), noise_variance=1e-8,
    ...                            tol=1e-12, mode="f64", device="cpu")
    >>> bool(abs(float(reg.mean(np.asarray([0.5]))[0]) - np.sin(1.5)) < 1e-4)
    True

    Parameters
    ----------
    prior:
        Scalar-output :class:`GaussianProcess`, any mean; kernels of the
        closed-form sum-of-products family take K1 and K2, others their
        dense Gram.
    X:
        ``(n,) + input_shape`` collocation points, or a ``TensorProductGrid``
        (grid mode).
    Y:
        ``(n,)`` observations of ``L u (x_i) + eps``.
    L:
        Optional linear differential operator applied to ``u`` at ``X``.
    noise_variance:
        Homoscedastic observation noise (also the CG regularizer).
    precond_rank:
        Rank of the Nyström preconditioner; ``"auto"`` picks 0 below
        1,024 observations and ``min(512, n // 4)`` above; 0 disables it.
    mode:
        ``"plain"``, ``"ff"`` or ``"f64"`` (``config.py``); sets the dtype
        of the operator batch's tensors.
    device:
        Where ``X``, ``Y`` and all solver state live; CUDA runs the
        kernels, CPU their plain versions.
    anchor_X, anchor_Y, anchor_noise:
        Optional ``(n1,) + input_shape`` points and ``(n1,)`` values of
        ``u(x) + eps`` with variance ``anchor_noise``, conditioned jointly.
        Modes ff and f64 hold the anchor blocks (``A11``'s factor, ``W``
        and the Schur correction) in float64, evaluated by the kernels in
        mode f64; plain mode holds them in float32.
    """

    def __init__(
        self,
        prior: GaussianProcess,
        X,
        Y,
        *,
        L=None,
        noise_variance: float = 1e-6,
        tol: float = 1e-6,
        maxiter: int = 512,
        precond_rank: int | str = "auto",
        mode: str | None = None,
        device=None,
        anchor_X=None,
        anchor_Y=None,
        anchor_noise: float = 1e-8,
    ):
        if prior.output_shape != ():
            raise ValueError("IterativeGPRegressor supports scalar outputs.")
        k = prior.cov
        if L is not None:
            k_obs = apply_operator_to_kernel(L, apply_operator_to_kernel(L, k, argnum=1), argnum=0)
            k_cross = apply_operator_to_kernel(L, k, argnum=1)
            mean_obs = prior.mean if isinstance(prior.mean, Zero) else L(prior.mean)
        else:
            k_obs = k_cross = k
            mean_obs = prior.mean
        grid = grid_factors(X)  # before X becomes a tensor, which drops the factors
        X = torch.as_tensor(np.asarray(X) if grid is not None else X).reshape((-1,) + tuple(prior.input_shape))
        self.prior = prior
        self.L = L
        self._k_obs, self._k_cross, self._mean_obs = k_obs, k_cross, mean_obs
        self._setup(kernel_term_specs(k_obs), kernel_term_specs(k_cross), X, Y, noise_variance, tol, maxiter,
                    precond_rank, mode, device, grid)
        if anchor_X is not None:
            if anchor_Y is None:
                raise ValueError("anchor_X needs anchor_Y")
            # W[i, j] = Cov(L u(X_i), u(X1_j)) = (L k)(X_i, X1_j).
            k_Lk = apply_operator_to_kernel(L, k, argnum=0) if L is not None else k
            self._setup_anchors(k_Lk, anchor_X, anchor_Y, anchor_noise)

    @classmethod
    def from_specs(
        cls,
        obs_spec,
        cross_spec,
        X,
        Y,
        *,
        noise_variance: float = 1e-6,
        tol: float = 1e-6,
        maxiter: int = 512,
        precond_rank: int | str = "auto",
        mode: str | None = None,
        device=None,
    ) -> "IterativeGPRegressor":
        """A regressor for given ``(scale, terms)`` specs of the
        observation kernel ``L k L*`` and the cross kernel ``k L*``, with
        ``X`` as ``(n, d)`` points; the other parameters as the
        constructor's (``X`` may be a ``TensorProductGrid``).  It has no prior,
        so no anchors and no variance."""
        self = cls.__new__(cls)
        self.prior = None
        self.L = None
        self._k_obs = self._k_cross = self._mean_obs = None
        grid = grid_factors(X)
        if grid is not None:
            X = np.asarray(X).reshape(-1, len(grid))
        self._setup(obs_spec, cross_spec, X, Y, noise_variance, tol, maxiter, precond_rank, mode, device, grid)
        return self

    def _setup(self, obs_spec, cross_spec, X, Y, noise_variance, tol, maxiter, precond_rank, mode, device, grid=None):
        self.mode = resolve_mode(mode)
        self.device = resolve_device(device)
        dtype = mode_dtype(self.mode)
        X = torch.as_tensor(X)
        self.X = X.reshape(X.shape[0], -1).to(device=self.device, dtype=dtype).contiguous()
        self.Y = torch.as_tensor(Y).reshape(-1).to(device=self.device, dtype=dtype)
        self.noise_variance = float(noise_variance)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self._obs_spec = obs_spec
        self._cross_spec = cross_spec
        self._grid_factors = grid
        self._dense_gram = None
        self._setup_grid()
        # Compact support along dimension 0 and no grid operator: the CG
        # matvec walks only the band, if the band skips column tiles
        # (iterative.py:235-247 of the JAX package).
        self._banded = None
        if (self._gram_linop is None and obs_spec is not None
                and compact_support_radius(obs_spec[1], 0) is not None):
            banded = make_banded_matvec(obs_spec, self.X, self.X, mode=self.mode)
            if banded.band_tiles < banded.total_tiles:
                self._banded = banded
        n = self.X.shape[0]
        if precond_rank == "auto":
            precond_rank = min(512, n // 4) if n >= 1024 else 0
        self.precond_rank = int(precond_rank)
        self._precond = None
        self._anchors = None
        self._weights = None
        self._anchor_weights = None
        self._solve_info = None
        self._var_info = None

    def _setup_grid(self):
        """``_gram_linop``, the observation Gram's Kronecker operator on a grid
        (``iterative.py:189-225`` of the JAX package), or ``None``: float64 in
        modes f64 and ff (ff splits its product into the CG's pair), float32
        in plain.  It is built from the spec and the factors rounded to the
        mode's dtype, as the points are stored, so that the CG operator and
        the K1 and K2 blocks (Nyström, anchors, mean, ``kxX``) see the same
        points."""
        self._gram_linop = None
        factors = self._grid_factors
        if factors is None or self._obs_spec is None or len(factors) < 2 or len(factors) != self.X.shape[1]:
            return
        np_dtype = np.float64 if self.mode == "f64" else np.float32
        factors = [np.asarray(g).astype(np_dtype).astype(np.float64) for g in factors]
        self._gram_linop = kron_linop(self._obs_spec, factors, dtype=self._dtype, device=self.device)

    # -- the anchor batch (iterative.py:255-279 of the JAX package) ------------
    @property
    def _anchor_mode(self) -> str:
        """The mode of the anchor blocks: f64 unless the regressor is plain."""
        return "plain" if self.mode == "plain" else "f64"

    def _setup_anchors(self, k_Lk, anchor_X, anchor_Y, anchor_noise):
        dt = mode_dtype(self._anchor_mode)
        X1 = torch.as_tensor(anchor_X).reshape((-1,) + tuple(self.prior.input_shape))
        X1 = X1.reshape(X1.shape[0], -1).to(device=self.device, dtype=dt).contiguous()
        with span("lgt.anchor.setup"):
            A11 = gram_matrix(self.prior.cov, X1, X1, self._anchor_mode)
            A11 = A11 + float(anchor_noise) * torch.eye(X1.shape[0], dtype=dt, device=self.device)
            self._anchors = dict(
                X1=X1,
                Y1=torch.as_tensor(anchor_Y).reshape(-1).to(device=self.device, dtype=dt),
                k_Lk=k_Lk,
                noise=float(anchor_noise),
                chol1=cholesky(A11, jitter=0.0),
                W=gram_matrix(k_Lk, self.X.to(dt), X1, self._anchor_mode),  # (n, n1)
            )

    # -- checkpoint / resume (utils/serialization.py) ------------------------------
    # The solved state and the geometry pickle; the banded schedule, the
    # grid operator and the dense Gram are dropped and rebuilt on load (from
    # the points, or the spec and the grid factors), on the device the
    # tensors come back on.  A prior mean or observation mean that does not
    # pickle (a LambdaFunction of a lambda) makes pickling fail, as it does
    # in the JAX package; it is never dropped.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_had_banded"] = self._banded is not None
        state["_banded"] = state["_gram_linop"] = state["_dense_gram"] = None
        return state

    def __setstate__(self, state):
        had_banded = state.pop("_had_banded", False)
        self.__dict__.update(state)
        self.device = self.X.device
        self._setup_grid()
        if had_banded:
            self._banded = make_banded_matvec(self._obs_spec, self.X, self.X, mode=self.mode)

    # ------------------------------------------------------------------
    def _precond_block_fn(self, x0, x1):
        """Observation-kernel block through K1 for the Nyström build; with
        anchors, the Schur operator's block ``k_LL(x0, x1) - U0 A11^{-1}
        U1^T`` (``iterative.py:378-418``), which is itself a PSD kernel:
        a preconditioner of ``A22`` alone leaves ~n1 directions badly
        mapped."""
        if self._obs_spec is None:
            out = gram_matrix(self._k_obs, x0, x1, self.mode)
        else:
            scale, terms = self._obs_spec
            out = gram(terms, x0, x1, self.mode)
            out = scale * out if scale != 1.0 else out
        a = self._anchors
        if a is not None:
            with span("lgt.anchor.precond"):
                dt = a["W"].dtype
                U0 = gram_matrix(a["k_Lk"], x0.to(dt), a["X1"], self._anchor_mode)
                U1 = gram_matrix(a["k_Lk"], x1.to(dt), a["X1"], self._anchor_mode)
                out = out.to(dt) - U0 @ cho_solve(a["chol1"], U1.T)
        return out

    def _preconditioner(self):
        """Lazily built Nyström preconditioner (None if rank 0).

        Modes ff and f64 build and apply its factors in float64.  In ff
        mode (float32 blocks from K1) a float32 build lost definiteness at
        N = 1e5, rank 8192: CG broke down at iteration 3 (PERF.md).
        On the card the float64 GEMMs cost about a second per build."""
        if self.precond_rank <= 0:
            return None
        if self._precond is None:
            idx = landmark_indices(self.X.shape[0], self.precond_rank, device=self.device)
            with span("lgt.nystrom.build"):
                self._precond = nystrom_preconditioner_device(
                    self._precond_block_fn, self.X, self.X[idx], self.noise_variance,
                    dtype=self._dtype,
                )
        return self._precond

    def _dense_obs_gram(self):
        """The observation Gram ``k_obs(X, X)`` of a kernel without a spec
        (float64, plain: float32), formed at first use and kept; ``None``
        for a kernel with a spec."""
        if self._obs_spec is not None:
            return None
        if self._dense_gram is None:
            self._dense_gram = gram_matrix(self._k_obs, self.X, None, "f64").to(self._dtype)
        return self._dense_gram

    def _gram_matvec_raw(self, v_ff):
        """Gram matvec of an ff pair (``(n,)`` or ``(n, r)`` planes) WITHOUT
        the noise shift (the CG applies sigma^2 itself, in float-float),
        routed as ``iterative.py:421-432`` of the JAX package: the grid
        operator, the banded kernel, K2, or a kernel without a spec's dense
        Gram.  Mode ff feeds both planes to the kernel and returns the
        result's ff pair (the grid operator and the dense Gram: the split of
        their float64 product); the other modes read the hi plane and return
        one tensor."""
        op = self._gram_linop if self._gram_linop is not None else self._dense_obs_gram()
        if op is not None:
            if self.mode == "ff":
                return ff_split(op @ (v_ff[0].double() + v_ff[1].double()), v_ff[0].dtype)
            return op @ v_ff[0]
        if self.mode != "ff":
            v_ff = v_ff[0]
        if self._banded is not None:
            return self._banded(v_ff)
        return gram_matvec(self._obs_spec, self.X, self.X, v_ff, self.mode)

    def _cg_matvec(self, v_ff):
        """The CG operator without the noise shift: the Gram matvec, minus
        the Schur correction ``W A11^{-1} W^T v`` with anchors
        (``iterative.py:343-351``).  The correction is formed and
        subtracted in the anchor blocks' dtype (float64 in modes ff and
        f64) before any rounding, since it can cancel against ``A22 v``;
        the CG takes the float64 result as an ff pair."""
        out = self._gram_matvec_raw(v_ff)
        a = self._anchors
        if a is None:
            return out
        with span("lgt.anchor.schur"):
            dt = a["W"].dtype
            v = v_ff[0].to(dt) + v_ff[1].to(dt)
            out = out[0].to(dt) + out[1].to(dt) if self.mode == "ff" else out.to(dt)
            return out - a["W"] @ cho_solve(a["chol1"], a["W"].T @ v)

    def _solve_device_cg(self, rhs: torch.Tensor):
        res = pcg_ff(
            self._cg_matvec,
            self._preconditioner(),
            rhs,
            self.noise_variance,
            tol=self.tol,
            maxiter=self.maxiter,
        )
        self._solve_info = (res.iterations, res.relative_residual)
        return res.x, res.x_lo

    @property
    def solve_info(self):
        """``(iterations, relative_residual)`` of the most recent solve."""
        return self._solve_info

    @property
    def var_info(self):
        """``[(iterations, relative_residual), ...]`` of the last
        :meth:`var` call's query blocks (the residual: its worst column)."""
        return self._var_info

    def refit(self, Y, anchor_Y=None) -> "IterativeGPRegressor":
        """Re-condition on new observation values (and new anchor values),
        reusing the Nyström preconditioner, the anchor factor and the band
        schedule (they depend only on the geometry); the next solve forms
        the residuals against the prior mean anew."""
        self.Y = torch.as_tensor(Y).reshape(-1).to(device=self.device, dtype=self.X.dtype)
        if anchor_Y is not None:
            if self._anchors is None:
                raise ValueError("the regressor was built without anchors")
            Y1 = self._anchors["Y1"]
            self._anchors["Y1"] = torch.as_tensor(anchor_Y).reshape(-1).to(Y1)
        self._weights = None
        self._anchor_weights = None
        self._solve_info = None
        return self

    @property
    def _dtype(self) -> torch.dtype:
        """The dtype of the solver's state past the points' precision (the
        Nyström factors, the dense Gram, residuals, the variance's quadratic
        form): float64 unless the mode is plain."""
        return torch.float32 if self.mode == "plain" else torch.float64

    def _mean_at(self, f, X) -> torch.Tensor | None:
        """The function ``f`` (a prior mean or ``L`` of it) at stored ``(n,
        d)`` points ``X``, evaluated in float64 on the points as stored (the
        points K1 and K2 see) and returned in :attr:`_dtype`; ``None`` for a
        zero or absent mean."""
        if f is None or isinstance(f, Zero):
            return None
        vals = f(X.double().reshape((-1,) + tuple(self.prior.input_shape)))
        return vals.reshape(-1).to(self._dtype)

    def _weights_ff(self):
        """The solved weights as the CG's ff pair ``(hi, lo)``; with anchors
        also the anchor weights (``iterative.py:515-529``).  The right-hand
        side is the residual ``Y - (L m)(X)`` (with anchors, minus ``W
        A11^{-1} (Y1 - m(X1))``), formed in float64 (plain: float32) and
        handed to the CG as an ff pair in mode ff."""
        if self._weights is None:
            a = self._anchors
            resid = self.Y.to(self._dtype)
            m_obs = self._mean_at(self._mean_obs, self.X)
            if m_obs is not None:
                resid = resid - m_obs
            if a is not None:
                with span("lgt.anchor.weights"):
                    r1 = a["Y1"]
                    m1 = self._mean_at(self.prior.mean, a["X1"])
                    if m1 is not None:
                        r1 = r1 - m1.to(r1)
                    resid = resid.to(r1) - a["W"] @ cho_solve(a["chol1"], r1)
            rhs = ff_split(resid.double(), self.X.dtype) if self.mode == "ff" else resid.to(self.X.dtype)
            self._weights = self._solve_device_cg(rhs)
            if a is not None:
                with span("lgt.anchor.weights"):
                    dt = a["W"].dtype
                    w = self._weights[0].to(dt) + self._weights[1].to(dt)
                    self._anchor_weights = cho_solve(a["chol1"], r1 - a["W"].T @ w)
        return self._weights

    @property
    def representer_weights(self) -> torch.Tensor:
        """The weights ``S^{-1} (r - W A11^{-1} r1)`` of the residuals ``r = Y
        - (L m)(X)`` and ``r1 = Y1 - m(X1)`` (``(K + sigma^2 I)^{-1} r``
        without anchors).  Mode ff returns them in float64 (``hi + lo``
        of the ff pair): rounding to float32 alone costs a 1.6e-3 true
        relative residual at N = 1e5, noise 1e-3 (PERF.md).  The other
        modes return the mode's dtype."""
        hi, lo = self._weights_ff()
        return hi.double() + lo.double() if self.mode == "ff" else hi

    @property
    def anchor_weights(self) -> torch.Tensor | None:
        """The anchor batch's weights ``A11^{-1} (r1 - W^T w)`` in the anchor
        blocks' dtype, or ``None`` without anchors."""
        self._weights_ff()
        return self._anchor_weights

    def _batch_shape(self, x) -> tuple:
        """The shape of the results at queries ``x`` (``iterative.py:534,553``
        of the JAX package): ``x.shape`` without the prior's input shape, or
        ``(nq,)`` for a regressor built from specs (queries ``(nq, d)``)."""
        shape = tuple(torch.as_tensor(x).shape)
        return shape[:1] if self.prior is None else shape[: len(shape) - len(self.prior.input_shape)]

    def _queries(self, x) -> torch.Tensor:
        """The queries as ``(nq, d)`` on the regressor's device."""
        x = torch.as_tensor(x)
        return x.reshape(size(self._batch_shape(x)), -1).to(device=self.device, dtype=self.X.dtype)

    def mean(self, x) -> torch.Tensor:
        """Posterior mean at ``batch + input_shape`` query points (or ``(nq,
        d)`` for a regressor built from specs), of shape ``batch``, on the
        regressor's device, in the mode's dtype: ``m(xq) + (k L*)(xq, X) @ w``
        (``iterative.py:532-552``), with anchors ``+ k(xq, X1) @
        anchor_weights``.  The terms are summed in float64 (plain: float32)
        and rounded once."""
        xq, batch = self._queries(x), self._batch_shape(x)
        w = self._weights_ff()
        if self._cross_spec is None:
            w64 = w[0].double() + w[1].double()
            mu = gram_matrix(self._k_cross, xq, self.X, "f64").to(self._dtype) @ w64.to(self._dtype)
        elif self.mode == "ff":
            hi, lo = gram_matvec(self._cross_spec, xq, self.X, w, self.mode)
            mu = hi.double() + lo.double()
        else:
            mu = gram_matvec(self._cross_spec, xq, self.X, w[0], self.mode)
        a = self._anchors
        if a is not None:
            with span("lgt.anchor.mean"):
                dt = a["W"].dtype
                k1 = gram_matrix(self.prior.cov, xq.to(dt), a["X1"], self._anchor_mode)
                mu = mu.to(dt) + k1 @ self._anchor_weights
        m = self._mean_at(None if self.prior is None else self.prior.mean, xq)
        if m is not None:
            mu = mu.to(m) + m
        return mu.to(self.X.dtype).reshape(batch)

    def var(self, x, *, block_size: int = 256, tol: float | None = None) -> torch.Tensor:
        """Posterior variance at ``batch + input_shape`` query points, of
        shape ``batch`` (``iterative.py:555-696``, the device branch): per block of
        ``block_size`` queries, ``kxX = (k L*)(xq, X)`` from K1, blocked ff
        CG on the ``(n, block)`` right-hand side through one shared K2 (or
        banded) launch per iteration, and the quadratic form ``U2 . S2``
        (``+ U1 . Z1`` with anchors, ``U1 = k(X1, xq)``); the result is
        ``max(prior_var - update, 0)`` with ``prior_var = k(xq, xq)``.

        Modes ff and f64 form the quadratic form and the subtraction in
        float64 and return float64 (ff, as :attr:`representer_weights`
        does); plain mode returns float32.  Mode ff evaluates ``kxX`` by K1
        in f64 and hands it to the CG as an ff pair, not rounded to f32.
        ``tol``: the CG tolerance of the variance solves (``None``: the
        regressor's); it is relative to
        each right-hand side, whose quadratic form can exceed the variance
        by orders of magnitude where the data pin the posterior down.
        :attr:`var_info` holds each block's ``(iterations,
        relative_residual)``."""
        if self.prior is None:
            raise ValueError("var needs the prior covariance; a regressor built by from_specs has none")
        xq, batch = self._queries(x), self._batch_shape(x)
        a = self._anchors
        dt = self._dtype
        M = self._preconditioner()
        updates, info = [], []
        # kxX in the quadratic form's dtype: f64 K1 on the points as stored.
        kx_mode = "plain" if self.mode == "plain" else "f64"
        for s in range(0, xq.shape[0], int(block_size)):
            xb = xq[s:s + int(block_size)]
            U2 = gram_matrix(self._k_cross, xb.to(dt), self.X.to(dt), kx_mode).T.contiguous()  # (n, b)
            rhs = U2
            if a is not None:
                U1 = gram_matrix(self.prior.cov, a["X1"], xb.to(dt), self._anchor_mode)  # (n1, b)
                T1 = cho_solve(a["chol1"], U1)
                rhs = U2 - a["W"] @ T1
            if rhs.dtype != self.X.dtype:
                rhs = ff_split(rhs, self.X.dtype)
            res = pcg_block_ff(self._cg_matvec, M, rhs, self.noise_variance, tol=self.tol if tol is None else tol,
                               maxiter=self.maxiter)
            info.append((res.iterations, res.relative_residual))
            S2 = res.x.to(dt) + res.x_lo.to(dt)
            update = torch.sum(U2 * S2, 0)
            if a is not None:
                Z1 = T1 - cho_solve(a["chol1"], a["W"].T @ S2)
                update = update + torch.sum(U1 * Z1, 0)
            updates.append(update)
        self._var_info = info
        prior_var = self.prior.cov(xq.to(dt).reshape((-1,) + tuple(self.prior.input_shape)))
        return torch.clamp(prior_var - torch.cat(updates), min=0.0).reshape(batch)

    def std(self, x, **kw) -> torch.Tensor:
        """Posterior standard deviation: ``sqrt(var(x, **kw))``."""
        return torch.sqrt(self.var(x, **kw))
