"""Gram-free iterative GP conditioning (streaming path).

Port of the streaming path of ``linpde_gp_tpu/models/iterative.py``:
representer weights by float-float preconditioned CG
(``ops/linalg/pcg.pcg_ff``) whose every Gram matvec streams through K2
(``ops/gram.gram_matvec``) without storing the Gram, preconditioned by
the floored all-device Nyström build whose kernel blocks come from K1
(``ops/gram.gram``).  The posterior mean is one cross-kernel K2 matvec.

The kernel enters as ``(scale, terms)`` specs (``specs.py``): the
observation kernel ``L k L*`` and the cross kernel ``L k``.  The prior
mean is zero.  Anchors, grid mode, the banded route and the variance
come with later slices.
"""

from __future__ import annotations

import torch

from ..config import mode_dtype, resolve_device, resolve_mode
from ..ops.gram import gram, gram_matvec
from ..ops.linalg.pcg import landmark_indices, nystrom_preconditioner_device, pcg_ff


class IterativeGPRegressor:
    """Condition a zero-mean scalar GP on one operator-observation set,
    gram-free.

    Parameters
    ----------
    obs_spec, cross_spec:
        ``(scale, terms)`` specs of the observation kernel ``L k L*`` and
        the cross kernel ``L k``.
    X:
        ``(n, d)`` collocation points.
    Y:
        ``(n,)`` observations of ``L u (x_i) + eps``.
    noise_variance:
        Homoscedastic observation noise (also the CG regularizer).
    precond_rank:
        Rank of the Nyström preconditioner; ``"auto"`` picks 0 below
        1,024 observations and ``min(512, n // 4)`` above; 0 disables it.
    mode:
        ``"plain"``, ``"ff"`` or ``"f64"`` (``config.py``); sets the dtype
        of every tensor the regressor holds.
    device:
        Where ``X``, ``Y`` and all solver state live; CUDA runs the
        kernels, CPU their plain versions.
    """

    def __init__(
        self,
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
    ):
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
        n = self.X.shape[0]
        if precond_rank == "auto":
            precond_rank = min(512, n // 4) if n >= 1024 else 0
        self.precond_rank = int(precond_rank)
        self._precond = None
        self._weights = None
        self._solve_info = None

    # ------------------------------------------------------------------
    def _precond_block_fn(self, x0, x1):
        """Observation-kernel block through K1 for the Nyström build."""
        scale, terms = self._obs_spec
        out = gram(terms, x0, x1, self.mode)
        return scale * out if scale != 1.0 else out

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
            self._precond = nystrom_preconditioner_device(
                self._precond_block_fn, self.X, self.X[idx], self.noise_variance,
                dtype=torch.float32 if self.mode == "plain" else torch.float64,
            )
        return self._precond

    def _gram_matvec_raw(self, v_ff) -> torch.Tensor:
        """Gram matvec of an ff pair WITHOUT the noise shift (pcg_ff
        applies sigma^2 itself, in float-float).  Mode ff feeds both planes
        to K2; the other modes read the hi plane."""
        v = v_ff if self.mode == "ff" else v_ff[0]
        return gram_matvec(self._obs_spec, self.X, self.X, v, self.mode)

    def _solve_device_cg(self, rhs: torch.Tensor):
        res = pcg_ff(
            self._gram_matvec_raw,
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

    def refit(self, Y) -> "IterativeGPRegressor":
        """Re-condition on new observation values, reusing the Nyström
        preconditioner (it depends only on the geometry)."""
        self.Y = torch.as_tensor(Y).reshape(-1).to(device=self.device, dtype=self.X.dtype)
        self._weights = None
        self._solve_info = None
        return self

    def _weights_ff(self):
        """The solved weights as the CG's ff pair ``(hi, lo)``."""
        if self._weights is None:
            self._weights = self._solve_device_cg(self.Y)
        return self._weights

    @property
    def representer_weights(self) -> torch.Tensor:
        """The weights ``(K + sigma^2 I)^{-1} Y``.  Mode ff returns them in
        float64 (``hi + lo`` of the ff pair): rounding to float32 alone
        costs a 1.6e-3 true relative residual at N = 1e5, noise 1e-3
        (PERF.md).  The other modes return the mode's dtype."""
        hi, lo = self._weights_ff()
        return hi.double() + lo.double() if self.mode == "ff" else hi

    def mean(self, x) -> torch.Tensor:
        """Posterior mean at ``(nq, d)`` query points, on the regressor's
        device, in the mode's dtype."""
        x = torch.as_tensor(x)
        xq = x.reshape(x.shape[0], -1).to(device=self.device, dtype=self.X.dtype)
        w = self._weights_ff()
        return gram_matvec(self._cross_spec, xq, self.X, w if self.mode == "ff" else w[0], self.mode)
