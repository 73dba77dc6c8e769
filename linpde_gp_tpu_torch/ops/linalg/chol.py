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

The posterior variance needs ``sum(q**2)`` per column of ``q = L^{-1} u``.
:func:`panel_solve_sumsq` computes it as a forward substitution by panels
of :data:`PANEL_ROWS` rows over the inverses of ``L``'s diagonal panels
(:func:`panel_inverses`, built once per factor), as MAGMA's ``dtrsm``
does: every step is a float64 matrix product (an ill-conditioned panel's
refined once), and the chain of dependent steps is one per panel, where
cuBLAS's ``dtrsm`` walks the diagonal 32 rows at a time whatever the width
of ``u``.  The JAX package leaves this solve to XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...config import config
from ...utils.profiling import span

#: Rows of the blocks :func:`_sym_` symmetrizes at once.
_SYM_BLOCK = 4096
#: Rows of a diagonal panel of :func:`panel_inverses` and
#: :func:`panel_solve_sumsq` (chosen on the H100 at n = 32,960: PERF.md).
PANEL_ROWS = 1024
#: The infinity-norm condition number above which a panel's solve in
#: :func:`panel_solve_sumsq` is refined.  On the dense IBVP at n = 32,960 the
#: anchors' panel reads 6,945 and the 32 others at most 97: refining the
#: first takes the variance's error from ~1e-7 to ~1e-9 of var, refining the
#: rest as well changes no digit of it and costs 1-2 ms a solve (PERF.md).
_REFINE_COND = 100.0


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
    with span("lgt.chol.factor"):
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
    with span("lgt.chol.extend"):
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


class Panels(NamedTuple):
    """A lower factor's diagonal panels, as :func:`panel_solve_sumsq`
    takes them (:func:`panel_inverses`)."""

    #: ``(panels, nb, nb)`` inverses; a ragged last panel is padded with the
    #: identity, so its inverse is the leading block of the padded one's.
    inverses: torch.Tensor
    #: Per panel, its lower triangle where the solve refines it (its
    #: condition number exceeds :data:`_REFINE_COND`), else ``None``.
    refine: tuple


def panel_inverses(chol_lower: torch.Tensor, nb: int | None = None) -> Panels:
    """The diagonal panels of ``nb`` rows (``None``: :data:`PANEL_ROWS`) of
    a lower factor, inverted in its dtype by one batched triangular solve
    against the identity, and kept where their solve is to be refined."""
    nb = PANEL_ROWS if nb is None else nb
    with span("lgt.chol.panel_inv"):
        n = chol_lower.shape[0]
        eye = torch.eye(nb, dtype=chol_lower.dtype, device=chol_lower.device)
        panels = eye.repeat(-(-n // nb), 1, 1)
        for k, k0 in enumerate(range(0, n, nb)):
            k1 = min(n, k0 + nb)
            panels[k, : k1 - k0, : k1 - k0] = torch.tril(chol_lower[k0:k1, k0:k1])
        inverses = torch.linalg.solve_triangular(panels, eye.expand_as(panels), upper=False)
        cond = torch.linalg.matrix_norm(panels, ord=math.inf) * torch.linalg.matrix_norm(inverses, ord=math.inf)
        return Panels(inverses, tuple(p.clone() if c > _REFINE_COND else None for p, c in zip(panels, cond.tolist())))


def panel_solve_sumsq(chol_lower: torch.Tensor, panels: Panels, b: torch.Tensor) -> torch.Tensor:
    """Column sums of squares of ``q = L^{-1} b`` for a lower factor ``L``
    (``chol_lower``, ``(n, n)``), its :func:`panel_inverses` and ``b`` of
    shape ``(n, m)``: a right-looking forward substitution, per panel ``k``
    ``q_k = inv(L_kk) b_k``, then ``b_{>k} -= L_{>k,k} q_k``: matrix
    products on views of ``L`` (no copy of it).  A product with an explicit
    inverse errs by about ``cond(L_kk) eps``, which the variance's
    cancellation (prior variance over posterior, up to ~3e6) multiplies, so
    an ill-conditioned panel's ``q_k`` is refined once, ``q_k += inv(L_kk)
    (b_k - L_kk q_k)``, which makes it as accurate as a substitution.  ``b``
    is copied once, and the copy holds ``q`` as it is solved; ``b`` itself
    is left as it is."""
    with span("lgt.chol.panel_solve"):
        n, nb = chol_lower.shape[0], panels.inverses.shape[-1]
        rest = b.clone()
        for inv, lower, k0 in zip(panels.inverses, panels.refine, range(0, n, nb)):
            r = min(nb, n - k0)
            inv = inv[:r, :r]
            q = inv @ rest[k0:k0 + r]
            if lower is not None:
                q.addmm_(inv, torch.addmm(rest[k0:k0 + r], lower[:r, :r], q, alpha=-1.0))
            rest[k0:k0 + r] = q
            if k0 + r < n:
                rest[k0 + r:].addmm_(chol_lower[k0 + r:, k0:k0 + r], q, alpha=-1.0)
        return torch.sum(rest.square_(), 0)


def logdet_from_chol(chol_lower: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol_lower)))
