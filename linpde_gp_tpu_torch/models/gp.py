"""Gaussian-process priors and the dense conditioning engine.

Port of ``linpde_gp_tpu/models/gp.py``: ``GaussianProcess`` with
``condition_on_observations``, and ``ConditionalGaussianProcess``, whose
conditioning on further observations grows ONE dense lower Cholesky
factor by ``chol_extend`` and never refactors the old block.  The engine
runs in float64 on the process's device (``device=``, default
``config.resolve_device()``): Gram and cross blocks come from
``ops/gram.gram_matrix`` (K1 on the card), the posterior mean's
``kLas(x) @ w`` from K2 where ``ops/crosscov/base.py`` routes it there,
and the factor, its extension and the triangular solves are cuSOLVER and
cuBLAS calls through torch.  With ``config.solve_refinement`` the factor
alone is float32 and solves are refined in float64
(``ops/linalg/refine.py``).  Inputs may be numpy arrays or tensors; the
results are tensors on the process's device.  The JAX package's
``*_jit`` properties have no counterpart: there is no jit to cache.
"""

from __future__ import annotations

import math

import torch

from ..config import as_f64, config, resolve_device
from ..ops.crosscov.base import ConcatenatedCrossCovariance, apply_functional_to_crosscov
from ..ops.functionals.base import LinearFunctional
from ..ops.functionals.evaluation import _EvaluationFunctional
from ..ops.kernels.base import CovarianceFunction
from ..ops.linalg import refine
from ..ops.linalg.chol import cho_solve, chol_extend, cholesky, logdet_from_chol, solve_triangular
from ..utils.profiling import span
from .functions.base import Function
from .randvars import Constant, Normal, asrandvar


def _state(x, device) -> torch.Tensor | None:
    """Numeric posterior state on ``device``, its dtype kept (the refined
    factor is float32)."""
    if x is None:
        return None
    return (x if isinstance(x, torch.Tensor) else torch.tensor(x)).to(device)


class GaussianProcess:
    """Prior GP ``u ~ GP(mean, cov)`` on ``device`` (``None``: the default
    device).

    >>> import numpy as np
    >>> import linpde_gp_tpu_torch as lgt
    >>> gp = lgt.GaussianProcess(
    ...     lgt.functions.Zero(()),
    ...     lgt.kernels.Matern((), nu=1.5, lengthscales=1.0), device="cpu")
    >>> post = gp.condition_on_observations(
    ...     np.asarray([0.0, 1.0]), X=np.asarray([0.0, 1.0]))
    >>> round(float(post.mean(0.5)), 4)
    0.5291

    Operator observations (here ``-u'' = 2`` at three points) shrink the
    posterior spread:

    >>> gp2 = lgt.GaussianProcess(
    ...     lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5), device="cpu")
    >>> D = -1.0 * lgt.diffops.Laplacian(())
    >>> post2 = gp2.condition_on_observations(
    ...     np.full(3, 2.0), X=np.linspace(-1.0, 1.0, 3), L=D)
    >>> bool(float(post2.std(0.0)) < float(gp2.std(0.0)))
    True
    """

    def __init__(self, mean: Function, cov: CovarianceFunction, device=None):
        if mean.input_shape != cov.input_shape:
            raise ValueError("mean/cov input shapes do not match")
        if mean.output_shape != cov.output_shape_0:
            raise ValueError("mean/cov output shapes do not match")
        self._mean = mean
        self._cov = cov
        self._device = resolve_device(device)

    @property
    def mean(self) -> Function:
        return self._mean

    @property
    def cov(self) -> CovarianceFunction:
        return self._cov

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def input_shape(self):
        return self._cov.input_shape

    @property
    def output_shape(self):
        return self._cov.output_shape_0

    # ------------------------------------------------------------------
    def __call__(self, X) -> Normal:
        """Marginal at points ``X`` (evaluation-functional layout)."""
        from ..ops.transforms.functionals import apply_functional

        L = _EvaluationFunctional(self.input_shape, self.output_shape, X, device=self._device)
        return apply_functional(L, self)

    def var(self, x) -> torch.Tensor:
        k = self._cov(as_f64(x, self._device))
        if self._cov.output_ndim_0 == 1 and self._cov.output_ndim_1 == 1:
            k = torch.diagonal(k, dim1=-2, dim2=-1)
        return k

    def std(self, x) -> torch.Tensor:
        # Clamp: posterior variances can round to tiny negatives.
        return torch.sqrt(torch.clamp(self.var(x), min=0.0))

    def sample(self, generator: torch.Generator | None, X, sample_shape=()):
        return self(X).sample(generator, sample_shape)

    def condition_on_observations(self, Y, X=None, *, L=None, b=None):
        return ConditionalGaussianProcess.from_observations(self, Y, X=X, L=L, b=b)

    # -- preprocessing (gp.py:133-191 of the JAX package) ------------------------
    @staticmethod
    def _preprocess_observations(prior: "GaussianProcess", Y, X, L, b):
        """``(Y, L, b, kLa, pred_mean, gram)``: the flattened observations,
        the functional, the noise, ``k L*``, ``L m (+ E b)`` and the Gram
        block ``L k L*`` with the noise covariance added in place, all on the
        prior's device."""
        from ..ops.diffops.linfuncop import LinearFunctionOperator
        from ..ops.transforms.functionals import apply_functional

        device = prior.device
        if isinstance(L, LinearFunctional):
            if X is not None:
                raise TypeError("If `L` is a LinearFunctional, `X` must be None.")
        elif isinstance(L, LinearFunctionOperator):
            if X is None:
                raise ValueError("`X` is required when `L` is an operator.")
            L = L.to_linfunctl(X, device=device)
        elif L is None:
            if X is None:
                raise ValueError("`X` and `L` cannot both be omitted.")
            L = _EvaluationFunctional(prior.input_shape, prior.output_shape, X, device=device)
        else:
            raise TypeError(f"Unsupported observation functional: {L!r}")

        if b is not None:
            b = asrandvar(b)
            if not isinstance(b, (Constant, Normal)):
                raise TypeError("`b` must be Normal or Constant")
            if tuple(b.shape) != tuple(L.output_shape):
                raise ValueError(f"noise shape {b.shape} != functional output {L.output_shape}")

        # Predictive moments through the rule engine.
        kLa = apply_functional(L, prior.cov, argnum=1)
        gram = apply_functional_to_crosscov(L, kLa).matrix.to(device)
        pred_mean = as_f64(L.apply_to_function(prior.mean), device).reshape(-1)

        # The observations in the evaluation functional's layout (codomain first).
        Y = as_f64(Y, device)
        out_ndim = len(prior.output_shape)
        if isinstance(L, _EvaluationFunctional) and out_ndim > 0:
            if tuple(Y.shape[-out_ndim:]) != tuple(prior.output_shape):
                raise ValueError(f"Expected Y with trailing shape {prior.output_shape}, got {tuple(Y.shape)}")
            Y = torch.movedim(Y, tuple(range(Y.ndim - out_ndim, Y.ndim)), tuple(range(out_ndim)))
        if tuple(Y.shape) != tuple(L.output_shape):
            raise ValueError(f"Expected Y of shape {L.output_shape}, got {tuple(Y.shape)}.")
        Y = Y.reshape(-1)

        if b is not None:
            pred_mean = pred_mean + b.mean.reshape(-1).to(pred_mean)
            gram = b.cov.add_to_(gram)
        return Y, L, b, kLa, pred_mean, gram


class _CholSolve:
    """Picklable plain Cholesky solver (posterior checkpoints)."""

    def __init__(self, chol):
        self.chol = chol

    def __call__(self, B):
        return cho_solve(self.chol, B)


class _RefinedSolve:
    """Picklable mixed-precision refined solver (``ops/linalg/refine``)."""

    def __init__(self, gram, chol):
        self.gram = gram
        self.chol = chol

    def __call__(self, B):
        return refine.refined_solve(self.gram, self.chol, B)


def _make_gram_solver(gram: torch.Tensor):
    """Factor a Gram and return ``(chol, gram_kept, solve)``: the float64
    Cholesky and ``cho_solve``, or with ``config.solve_refinement`` a
    float32 factor (nugget ``refine.FACTOR_JITTER``) and the refined
    float64 solver, which keeps the Gram for its matvecs and extension."""
    if config.solve_refinement and gram.dtype == torch.float64:
        chol = cholesky(gram.to(torch.float32), jitter=refine.FACTOR_JITTER)
        return chol, gram, _RefinedSolve(gram, chol)
    chol = cholesky(gram)
    return chol, None, _CholSolve(chol)


class ConditionalGaussianProcess(GaussianProcess):
    """Posterior GP after conditioning on linear-functional observations.

    The numeric state (``chol``, ``residuals``, ``representer_weights``,
    ``gram``) may be given as numpy arrays or tensors; it is put on the
    prior's device with its dtype kept.
    """

    def __init__(self, *, prior: GaussianProcess, Ys, Ls, bs, kLas: ConcatenatedCrossCovariance, chol, residuals,
                 representer_weights, gram=None, solve=None):
        device = prior.device
        chol = _state(chol, device)
        self._prior = prior
        self._Ys = tuple(Ys)
        self._Ls = tuple(Ls)
        self._bs = tuple(bs)
        self._kLas = kLas
        self._chol = chol
        self._gram = _state(gram, device)
        self._residuals = _state(residuals, device)
        self._representer_weights = _state(representer_weights, device)
        self._solve = _CholSolve(chol) if solve is None else solve
        # The covariance takes the refined solver only in refinement mode (a
        # Gram is kept); with a float64 factor it takes the triangular paths,
        # as ``var`` does, where the JAX package's first posterior passes its
        # Cholesky solver.
        super().__init__(
            mean=ConditionalMean(prior.mean, kLas, self._representer_weights),
            cov=ConditionalCovariance(prior.cov, kLas, chol, solve=None if self._gram is None else solve),
            device=device,
        )

    # -- checkpoints: the device is where the tensors were loaded ----------------
    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device = self._chol.device
        self._prior._device = self._device

    # ------------------------------------------------------------------
    @classmethod
    def from_observations(cls, prior, Y, X=None, *, L=None, b=None):
        Y, L, b, kLa, pred_mean, gram = GaussianProcess._preprocess_observations(prior, Y, X, L, b)
        chol, gram_kept, solve = _make_gram_solver(gram)
        resid = Y - pred_mean
        weights = solve(resid)
        return cls(
            prior=prior,
            Ys=(Y,),
            Ls=(L,),
            bs=(b,),
            kLas=ConcatenatedCrossCovariance((kLa,)),
            chol=chol,
            residuals=resid,
            representer_weights=weights,
            gram=gram_kept,
            solve=solve,
        )

    @property
    def prior(self) -> GaussianProcess:
        return self._prior

    @property
    def gram_cholesky(self) -> torch.Tensor:
        return self._chol

    @property
    def representer_weights(self) -> torch.Tensor:
        return self._representer_weights

    @property
    def kLas(self) -> ConcatenatedCrossCovariance:
        return self._kLas

    @property
    def log_marginal_likelihood(self) -> torch.Tensor:
        """``log p(Y | prior)`` of all conditioned observations."""
        n = self._residuals.shape[0]
        quad = torch.dot(self._residuals, self._representer_weights)
        return -0.5 * (quad + logdet_from_chol(self._chol).to(quad) + n * math.log(2.0 * math.pi))

    def condition_on_observations(self, Y, X=None, *, L=None, b=None):
        """Incremental conditioning: extends the cached Cholesky factor and
        never refactors the old Gram (``gp.py:326`` of the JAX package)."""
        Y, L, b, kLa, pred_mean, gram = GaussianProcess._preprocess_observations(self._prior, Y, X, L, b)
        # The new functional's cross-covariance with every earlier one (m, n).
        cross = apply_functional_to_crosscov(L, self._kLas).matrix.to(self._device)
        gram_kept = solve = None
        if self._gram is not None:
            # Refinement: the float64 Gram grows beside the float32 factor.
            gram_kept = torch.cat([torch.cat([self._gram, cross.T], 1), torch.cat([cross, gram], 1)], 0)
        # In plain mode the new block is the float64 Gram itself, and its
        # memory becomes the Schur complement.
        chol = chol_extend(self._chol, cross.T.to(self._chol.dtype), gram.to(self._chol.dtype))
        del gram, cross
        resid = torch.cat([self._residuals, Y - pred_mean])
        if gram_kept is not None:
            solve = _RefinedSolve(gram_kept, chol)
            weights = solve(resid)
        else:
            weights = cho_solve(chol, resid)
        return ConditionalGaussianProcess(
            prior=self._prior,
            Ys=self._Ys + (Y,),
            Ls=self._Ls + (L,),
            bs=self._bs + (b,),
            kLas=self._kLas.append(kLa),
            chol=chol,
            residuals=resid,
            representer_weights=weights,
            gram=gram_kept,
            solve=solve,
        )

    # ------------------------------------------------------------------
    def _apply_operator(self, op) -> "ConditionalGaussianProcess":
        """Operator pushforward ``T(u | obs)`` reusing the Gram factor and
        the weights (``gp.py:363`` of the JAX package)."""
        from ..ops.transforms.dispatch import apply_operator

        new_prior = GaussianProcess(
            mean=apply_operator(op, self._prior.mean), cov=apply_operator(op, self._prior.cov), device=self._device
        )
        return ConditionalGaussianProcess(
            prior=new_prior,
            Ys=self._Ys,
            Ls=self._Ls,
            bs=self._bs,
            kLas=self._kLas.apply_operator(op),
            chol=self._chol,
            residuals=self._residuals,
            representer_weights=self._representer_weights,
            gram=self._gram,
            solve=self._solve,
        )

    def solve_gram(self, B: torch.Tensor) -> torch.Tensor:
        """Solve ``Gram @ X = B`` through the posterior's solver (refined in
        mixed-precision mode, plain Cholesky otherwise)."""
        return self._solve(B)

    def var(self, x) -> torch.Tensor:
        """Pointwise posterior variance at ``batch + input_shape`` points."""
        with span("lgt.gp.var"):
            x = as_f64(x, self._device)
            with span("lgt.gp.crosscov"):
                u = self._kLas.evaluate(x)  # batch + out + (n,)
            prior_var = self._prior.var(x)
            n = u.shape[-1]
            ut = u.reshape(-1, n).T
            with span("lgt.gp.var.solve"):
                if self._gram is None:
                    q = solve_triangular(self._chol, ut)
                    update = torch.sum(q**2, 0).reshape(u.shape[:-1])
                else:
                    update = torch.sum(ut * self._solve(ut), 0).reshape(u.shape[:-1])
            return torch.clamp(prior_var - update, min=0.0)


class ConditionalMean(Function):
    """``m(x) + kLas(x) @ weights``, on the weights' device."""

    def __init__(self, prior_mean, kLas, weights):
        self._prior_mean = prior_mean
        self._kLas = kLas
        self._weights = weights
        super().__init__(prior_mean.input_shape, prior_mean.output_shape)

    def __call__(self, x):
        return super().__call__(as_f64(x, self._weights.device))

    def _evaluate(self, x):
        with span("lgt.gp.mean"):
            m = self._prior_mean._evaluate(x)
            batch = tuple(x.shape[: x.ndim - self.input_ndim])
            m = torch.broadcast_to(m, batch + self.output_shape)
            # matvec takes K2 where the crosscov routes it there.
            with span("lgt.gp.crosscov"):
                mu = self._kLas.matvec(x, self._weights)
            return m + mu


class ConditionalCovariance(CovarianceFunction):
    """``k(x0, x1) - kLas(x0) K^{-1} kLas(x1)^T``, on the factor's device."""

    def __init__(self, prior_cov: CovarianceFunction, kLas, chol, *, solve=None):
        self._prior_cov = prior_cov
        self._kLas = kLas
        self._chol = chol
        # Optional refined solver (``ops/linalg/refine``); None selects the
        # plain Cholesky paths.
        self._refined = solve
        super().__init__(prior_cov.input_shape, prior_cov.output_shape_0, prior_cov.output_shape_1)

    def _x(self, x):
        return as_f64(x, self._chol.device)

    def __call__(self, x0, x1=None):
        return super().__call__(self._x(x0), None if x1 is None else self._x(x1))

    def _solve_gram(self, B):
        return self._refined(B) if self._refined is not None else cho_solve(self._chol, B)

    def _evaluate(self, x0, x1):
        k = self._prior_cov._evaluate(x0, x1)
        u0 = self._kLas.evaluate(x0)  # batch0 + out0 + (n,)
        u1 = self._kLas.evaluate(x1)  # batch1 + out1 + (n,)
        n = u0.shape[-1]
        v1 = self._solve_gram(u1.reshape(-1, n).T).T.reshape(u1.shape)
        d0, d1 = self.output_ndim_0, self.output_ndim_1
        if d0 == 0 and d1 == 0:
            update = torch.sum(u0 * v1, -1)
        else:
            # Outer product over the codomain axes.
            u0e = u0.reshape(tuple(u0.shape[:-1]) + (1,) * d1 + (n,))
            v1e = v1.reshape(tuple(v1.shape[: v1.ndim - 1 - d1]) + (1,) * d0 + tuple(v1.shape[-1 - d1:-1]) + (n,))
            update = torch.sum(u0e * v1e, -1)
        return k - update

    def matrix(self, X0, X1=None):
        from ..ops.gram import gram_matrix, kernel_term_specs

        X0 = self._x(X0)
        X1 = None if X1 is None else self._x(X1)
        k = self._prior_cov
        # The prior's Gram by K1 where the kernel has a spec, as every other block.
        if k.output_shape_0 == () and k.output_shape_1 == () and kernel_term_specs(k) is not None:
            K = gram_matrix(k, X0, X1, "f64")
        else:
            K = k.matrix(X0, X1)
        device = self._chol.device
        disc0 = _EvaluationFunctional(self.input_shape, self.output_shape_0, X0, device=device)
        u0 = apply_functional_to_crosscov(disc0, self._kLas).matrix
        if X1 is None:
            u1 = u0
        else:
            disc1 = _EvaluationFunctional(self.input_shape, self.output_shape_1, X1, device=device)
            u1 = apply_functional_to_crosscov(disc1, self._kLas).matrix
        if self._refined is not None:
            return K - u0 @ self._refined(u1.T)
        q0 = solve_triangular(self._chol, u0.T)
        q1 = q0 if X1 is None else solve_triangular(self._chol, u1.T)
        return K - q0.T @ q1


__all__ = ["GaussianProcess", "ConditionalGaussianProcess", "ConditionalMean", "ConditionalCovariance"]
