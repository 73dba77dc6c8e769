"""Robust Cholesky factorization and triangular solves.

Port of the main-path part of ``linpde_gp_tpu/ops/linalg/chol.py``.
JAX signals a failed factorization with NaNs and the JAX package retries
on them; torch reports it through ``cholesky_ex``'s ``info``, which is
what the retry reads here.
"""

from __future__ import annotations

import torch


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.T)


def cholesky(gram: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor with an explicit nugget policy.

    ``jitter`` (relative to the mean diagonal) is always added.  A failed
    factorization retries with escalating relative jitter ``eps, 100 eps,
    ...`` below ``1e7 eps`` (``chol.py:61-67`` of the JAX package), and
    raises if every rung fails.
    """
    gram = _sym(gram)
    n = gram.shape[-1]
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    diag_scale = torch.mean(torch.diagonal(gram))
    if jitter:
        gram = gram + (jitter * diag_scale) * eye
    chol, info = torch.linalg.cholesky_ex(gram)
    eps = torch.finfo(gram.dtype).eps
    rel = eps
    while int(info) != 0 and rel < 1e7 * eps:
        chol, info = torch.linalg.cholesky_ex(gram + (rel * diag_scale) * eye)
        rel *= 100.0
    if int(info) != 0:
        raise torch.linalg.LinAlgError(
            f"Cholesky failed at relative jitter up to {rel / 100.0:.3g} (leading minor {int(info)})"
        )
    return chol


def solve_triangular(chol_lower: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``L^T x = b`` when ``trans``)."""
    vector = b.ndim == 1
    if vector:
        b = b[:, None]
    A = chol_lower.T if trans else chol_lower
    x = torch.linalg.solve_triangular(A, b, upper=trans)
    return x[:, 0] if vector else x


def cho_solve(chol_lower: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b``."""
    return solve_triangular(chol_lower, solve_triangular(chol_lower, b), trans=True)
