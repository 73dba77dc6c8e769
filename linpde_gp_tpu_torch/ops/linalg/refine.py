"""Mixed-precision iterative refinement for Gram solves.

Port of ``linpde_gp_tpu/ops/linalg/refine.py`` (``refined_solve``,
``:46``), used by the dense engine when ``config.solve_refinement`` is
on: the O(n^3) Cholesky runs once in float32 (with a ~1e-6 relative
nugget), and the float64 system ``(G + jt I) x = b`` is solved by
preconditioned CG whose every iteration is one float64 matvec and two
triangular solves against that factor.  As in the JAX package:

1. the Gram is kept in float64 (rounding it to float32 loses the small
   eigenvalues the 1e-6 parity target needs);
2. the float32 factor is upcast once and applied in float64, so the
   preconditioner is an exact SPD operator and CG converges monotonically.

The JAX package solves the columns of a matrix right-hand side one at a
time (``vmap`` of ``pcg``); here they share one GEMM an iteration through
``pcg_block``, which freezes each converged column where a per-column
``pcg`` stops (alpha and beta 0 from then on).
"""

from __future__ import annotations

import torch

from .chol import cho_solve
from .pcg import pcg, pcg_block

#: Relative nugget of the float32 factor (JAX ``config.refine_factor_jitter``).
FACTOR_JITTER = 1e-6


def refined_solve(gram: torch.Tensor, chol_lo: torch.Tensor, b: torch.Tensor, *, tol: float | None = None,
                  maxiter: int = 400, target_jitter: float = 1e-12) -> torch.Tensor:
    """Solve ``(gram + jt I) x = b`` in ``gram``'s (high) precision,
    preconditioned by a low-precision Cholesky factor ``chol_lo`` of
    ``gram``; ``jt = target_jitter * mean(diag(gram))``.  ``b``: ``(n,)`` or
    ``(n, m)``.  ``tol`` defaults to 30 eps of ``gram``'s dtype; the
    defaults are the JAX package's ``config.refine_*``."""
    hi = gram.dtype
    if tol is None:
        tol = 30.0 * torch.finfo(hi).eps
    chol_hi = chol_lo.to(hi)  # once: the float32 factor as an exact SPD operator in float64
    jt = target_jitter * float(torch.mean(torch.diagonal(gram)))

    def precond(r):
        return cho_solve(chol_hi, r)

    def matvec(v):
        return gram @ v + jt * v

    b = b.to(hi)
    solver = pcg if b.ndim == 1 else pcg_block
    return solver(matvec, b, M=precond, tol=tol, maxiter=maxiter).x
