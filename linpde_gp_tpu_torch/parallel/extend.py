"""Incremental (Schur) extension of a distributed Cholesky factor.

Port of ``linpde_gp_tpu/parallel/extend.py``.  The large base factor ``L``
stays distributed (a :class:`~.cholesky.BlockRows`) and is never
refactored.  Appending an observation batch ``(B: size x m, D: m x m)``
costs one multi-RHS distributed forward solve ``Y = L^{-1} B``, one small
Cholesky of the Schur complement ``D - Y^T Y`` (replicated, by
``ops/linalg/chol.cholesky``: its jitter, its ladder, ``LinAlgError`` if
every rung fails) and O(size m) storage for the new off-diagonal panel.
Solves run forward through ``L`` and then the extension chain, backward
in reverse; each extension is a replicated dense block (observation
batches are small next to the base problem).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..ops.linalg.chol import cholesky
from .cholesky import BlockRows, distributed_tri_solve
from .mesh import Mesh


class DistributedCholFactor:
    """A distributed lower Cholesky factor plus a chain of Schur
    extensions, with ``extend``, ``solve`` and ``logdet``; the base block is
    never refactored."""

    def __init__(self, chol: BlockRows, *, mesh: Mesh, block_size: int = 512):
        if not isinstance(chol, BlockRows):
            from .cholesky import _as_rows

            chol = _as_rows(chol, mesh, block_size)
        self.chol = chol
        self.mesh = mesh
        self.block_size = chol.nb
        self.extensions: list[tuple[torch.Tensor, torch.Tensor]] = []

    @property
    def base_size(self) -> int:
        return self.chol.n

    @property
    def size(self) -> int:
        return self.base_size + sum(l22.shape[0] for _, l22 in self.extensions)

    def _rhs(self, rhs) -> tuple[torch.Tensor, bool]:
        r = torch.as_tensor(rhs).to(device=self.mesh.device, dtype=self.chol.local.dtype)
        return (r[:, None], True) if r.ndim == 1 else (r, False)

    def _solve_lower(self, rhs) -> torch.Tensor:
        """Forward substitution through the extended factor; ``rhs``:
        ``(size,)`` or ``(size, k)``, the same on every rank."""
        r, vector = self._rhs(rhs)
        n0 = self.base_size
        out = torch.empty_like(r)
        out[:n0] = distributed_tri_solve(self.chol, r[:n0], mesh=self.mesh)
        off = n0
        for l21, l22 in self.extensions:
            m = l22.shape[0]
            s = l21 @ out[:off]
            out[off:off + m] = torch.linalg.solve_triangular(l22, r[off:off + m] - s, upper=False)
            off += m
        return out[:, 0] if vector else out

    def _solve_upper(self, rhs) -> torch.Tensor:
        """Backward substitution ``L^T x = rhs`` through the chain."""
        r, vector = self._rhs(rhs)
        n0 = self.base_size
        offs = np.concatenate([[n0], n0 + np.cumsum([l22.shape[0] for _, l22 in self.extensions])]).astype(int)
        out = torch.empty_like(r)
        corr = torch.zeros_like(r)  # the solved trailing blocks' share of the leading rows
        for i in range(len(self.extensions) - 1, -1, -1):
            l21, l22 = self.extensions[i]
            lo, hi = offs[i], offs[i + 1]
            x_i = torch.linalg.solve_triangular(l22.T, r[lo:hi] - corr[lo:hi], upper=True)
            out[lo:hi] = x_i
            corr[:lo] += l21.T @ x_i
        out[:n0] = distributed_tri_solve(self.chol, r[:n0] - corr[:n0], mesh=self.mesh, transpose=True)
        return out[:, 0] if vector else out

    def solve(self, rhs) -> torch.Tensor:
        """Solve ``(L L^T) x = rhs`` through the extended factor."""
        return self._solve_upper(self._solve_lower(rhs))

    def extend(self, B, D, *, jitter: float | None = None) -> "DistributedCholFactor":
        """Append a block row and column: the factor then represents
        ``[[A, B], [B^T, D]]`` for the current matrix ``A``.  ``B``:
        ``(size, m)``; ``D``: ``(m, m)`` SPD.  Returns ``self``, with the
        base factor untouched."""
        B, _ = self._rhs(B)
        D = torch.as_tensor(D).to(B)
        m = D.shape[0]
        if tuple(B.shape) != (self.size, m):
            raise ValueError(f"B is {tuple(B.shape)}, expected {(self.size, m)}")
        y = self._solve_lower(B)
        l22 = cholesky(D - y.T @ y, jitter=config.cholesky_jitter if jitter is None else jitter)
        self.extensions.append((y.T.contiguous(), l22))
        return self

    def logdet(self) -> torch.Tensor:
        """``log det A`` from the factors' diagonals."""
        total = 2.0 * torch.sum(torch.log(torch.diagonal(self.chol.diag_blocks(), dim1=1, dim2=2)))
        for _, l22 in self.extensions:
            total = total + 2.0 * torch.sum(torch.log(torch.diagonal(l22)))
        return total
