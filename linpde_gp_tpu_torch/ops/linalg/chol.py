"""Robust Cholesky factorization, triangular solves and the incremental
Cholesky extension of the dense conditioning engine.

Port of ``linpde_gp_tpu/ops/linalg/chol.py``.  JAX signals a failed
factorization with NaNs and the JAX package retries on them; torch
reports it through ``cholesky_ex``'s ``info``, which is what the retry
reads here.  :func:`chol_extend` grows one dense lower factor by an
observation block,

    K' = [[K, B], [B^T, D]],   L' = [[L, 0], [C^T, L_S]],
    C = L^{-1} B,   L_S = chol(D - C^T C),

writing ``L'`` into one preallocated tensor (the JAX package concatenates
three times; at n = 32,768 each copy is 8.6 GB in float64).
"""

from __future__ import annotations

import torch

from ...config import config

#: Rows of the blocks :func:`_sym_` symmetrizes at once.
_SYM_BLOCK = 4096


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.T)


def _sym_(a: torch.Tensor) -> torch.Tensor:
    """:func:`_sym` in place, a block pair at a time (no second matrix)."""
    n = a.shape[0]
    for i in range(0, n, _SYM_BLOCK):
        for j in range(0, i + 1, _SYM_BLOCK):
            lower = a[i:i + _SYM_BLOCK, j:j + _SYM_BLOCK]
            upper = a[j:j + _SYM_BLOCK, i:i + _SYM_BLOCK]
            avg = 0.5 * (lower + upper.T)
            lower.copy_(avg)
            upper.copy_(avg.T)
    return a


def _with_diagonal(gram: torch.Tensor, amount: float) -> torch.Tensor:
    out = gram.clone()
    out.diagonal().add_(amount)
    return out


def _factor(gram: torch.Tensor, jitter: float) -> torch.Tensor:
    """Lower factor of a symmetric ``gram``: ``jitter`` (relative to the
    mean diagonal) always added; on failure the escalating relative jitter
    ``eps, 100 eps, ...`` below ``1e7 eps`` (``chol.py:61-67`` of the JAX
    package); raises if every rung fails."""
    diag_scale = float(torch.mean(torch.diagonal(gram)))
    if jitter:
        gram = _with_diagonal(gram, jitter * diag_scale)
    chol, info = torch.linalg.cholesky_ex(gram)
    eps = torch.finfo(gram.dtype).eps
    rel = eps
    while int(info) != 0 and rel < 1e7 * eps:
        chol, info = torch.linalg.cholesky_ex(_with_diagonal(gram, rel * diag_scale))
        rel *= 100.0
    if int(info) != 0:
        raise torch.linalg.LinAlgError(
            f"Cholesky failed at relative jitter up to {rel / 100.0:.3g} (leading minor {int(info)})"
        )
    return chol


def cholesky(gram: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Lower Cholesky factor with an explicit nugget policy: ``jitter``
    (``None``: ``config.cholesky_jitter``), relative to the mean diagonal,
    is always added, and a failed factorization retries with escalating
    relative jitter (:func:`_factor`)."""
    return _factor(_sym(gram), config.cholesky_jitter if jitter is None else jitter)


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


def chol_extend(chol_lower: torch.Tensor, cross: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Extend a Cholesky factor by one observation block.

    ``chol_lower``: ``(n, n)`` lower factor of the Gram ``K``; ``cross``:
    ``(n, m)`` cross block ``B = K(old, new)``; ``block``: ``(m, m)`` new
    diagonal block ``D`` (noise included).  Returns the ``(n+m, n+m)``
    lower factor of ``[[K, B], [B^T, D]]``, built in one tensor; the Schur
    complement ``D - C^T C`` is formed in ``block``'s memory (``block`` is
    overwritten: at n = 32,768 a copy is 8.6 GB), symmetrized and factored
    by :func:`cholesky`'s rules.
    """
    n, m = chol_lower.shape[0], block.shape[0]
    c = torch.linalg.solve_triangular(chol_lower, cross, upper=False)  # (n, m)
    block.addmm_(c.T, c, alpha=-1.0)
    chol_schur = _factor(_sym_(block), config.cholesky_jitter)
    out = torch.empty((n + m, n + m), dtype=chol_lower.dtype, device=chol_lower.device)
    out[:n, :n] = chol_lower
    out[:n, n:] = 0.0
    out[n:, :n] = c.T
    out[n:, n:] = chol_schur
    return out


def logdet_from_chol(chol_lower: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol_lower)))
