"""Distributed blocked Cholesky factorization and triangular solves.

Port of ``linpde_gp_tpu/parallel/cholesky.py``.  A distributed matrix is a
:class:`BlockRows`: its rows in blocks of ``nb``, each rank holding an equal
number of whole row blocks, any block-to-rank table (every rank knows the
whole table).  The JAX package passes global arrays and lets ``shard_map``
reshard them between functions without being asked (the cyclic factor
comes back in natural order and the solver reads it as contiguous slabs);
here each layout's factor stays where it was computed, and the solves take
any table, so no layout change costs a collective.

- :func:`distributed_cholesky` (contiguous row slabs) and
  :func:`distributed_cholesky_cyclic` (block ``g`` on rank ``g mod P``) are
  one right-looking algorithm on two tables: per block-column ``k`` its
  owner broadcasts the diagonal block, every rank factors it redundantly
  (``cholesky_ex``; a failed pivot raises ``LinAlgError`` on every rank at
  once), solves its own panel rows, all-gathers the panel rows below the
  block (padded to equal pieces) and updates its own trailing rows.
- :func:`distributed_cholesky_2d`: 2-D block-cyclic tiles over ``rows x
  cols`` with ``Pr | Pc`` (ScaLAPACK ``pdpotrf``): the diagonal block is
  broadcast, the owning column solves the panel, a row route along
  ``cols`` and a transpose route along ``rows`` bring each rank the panel
  blocks of its rows and of its columns, and the trailing update is one
  local GEMM.  The factor is then regathered along ``cols`` into row blocks
  (block ``t P + c Pr + r`` on rank ``(r, c)``), which the solves read.
- :func:`distributed_tri_solve` and :func:`distributed_chol_solve`:
  blocked substitution against any table, multi-RHS, replicated results.
  Forward: the owner of block ``k`` solves it and broadcasts it; every rank
  folds it into its rows' accumulator.  Backward: every rank sums its rows'
  contribution, one ``all_reduce``, and solves against the diagonal
  blocks, gathered once per factor.

Everything runs at exact width: the JAX package's masked full-width
updates and its ``unroll`` switch exist to give XLA static shapes; ``unroll``
is accepted for the signatures' sake and changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from .mesh import Mesh


class BlockRows:
    """An ``(n, ncols)`` matrix distributed by row blocks of ``nb`` rows:
    ``table[p]`` lists, ascending, the global block ids rank ``p`` holds, and
    ``local`` is this rank's ``(len(table[p]) * nb, ncols)`` rows in that
    order, on the mesh's device."""

    def __init__(self, local: torch.Tensor, table: np.ndarray, nb: int, mesh: Mesh):
        self.local = local
        self.table = np.asarray(table, dtype=np.int64)
        self.nb = int(nb)
        self.mesh = mesh
        self.n = self.table.size * self.nb
        self.blocks = self.table[mesh.rank]
        owner = np.empty(self.table.size, np.int64)
        slot = np.empty(self.table.size, np.int64)
        for p, row in enumerate(self.table):
            owner[row] = p
            slot[row] = np.arange(row.size)
        self.owner, self.slot = owner, slot
        self._diag = None

    def first_after(self, k: int) -> int:
        """Local slot of this rank's first block after block ``k``."""
        return int(np.searchsorted(self.blocks, k, side="right"))

    def full(self) -> torch.Tensor:
        """The whole matrix in natural row order, on every rank (one
        ``all_gather``: for tests and small matrices)."""
        parts = self.mesh.all_gather(self.local).reshape(-1, self.nb, self.local.shape[1])
        out = torch.empty_like(parts)
        out[torch.as_tensor(self.table.reshape(-1), device=parts.device)] = parts
        return out.reshape(self.n, -1)

    def diag_blocks(self) -> torch.Tensor:
        """The ``(n / nb, nb, nb)`` diagonal blocks, on every rank (gathered
        once and kept)."""
        if self._diag is None:
            nb = self.nb
            mine = torch.stack([self.local[s * nb:(s + 1) * nb, g * nb:(g + 1) * nb]
                                for s, g in enumerate(self.blocks.tolist())])
            parts = self.mesh.all_gather(mine)
            diag = torch.empty_like(parts)
            diag[torch.as_tensor(self.table.reshape(-1), device=parts.device)] = parts
            self._diag = diag
        return self._diag


def contiguous_table(nblocks: int, P: int) -> np.ndarray:
    """Rank ``p`` holds blocks ``[p B, (p + 1) B)``, ``B = nblocks / P``."""
    return np.arange(nblocks).reshape(P, nblocks // P)


def cyclic_table(nblocks: int, P: int) -> np.ndarray:
    """Rank ``p`` holds blocks ``p, p + P, p + 2P, ...`` (1-D block-cyclic)."""
    return np.arange(nblocks).reshape(nblocks // P, P).T.copy()


def _check_n(n: int, quantum: int, what: str) -> None:
    if n % quantum:
        raise ValueError(f"n={n} must be divisible by {what}={quantum} (pad upstream)")


def _rows_of(gram, mesh: Mesh, blocks: np.ndarray, nb: int, cols=None) -> torch.Tensor:
    """Row blocks ``blocks`` (all columns, or ``cols``) of ``gram``: a full
    ``(n, n)`` tensor or array (each rank takes its rows), or a callable
    ``gram(rows, cols)`` of index tensors returning the entries, with the
    matrix size as ``gram.n``."""
    rows = torch.as_tensor((np.asarray(blocks)[:, None] * nb + np.arange(nb)).reshape(-1), device=mesh.device)
    if callable(gram):
        return gram(rows, torch.arange(gram.n, device=mesh.device) if cols is None else cols)
    g = torch.as_tensor(gram, dtype=torch.float64).to(mesh.device)
    out = g[rows]
    return out if cols is None else out[:, cols]


def _add_jitter(diag_views, n: int, mesh: Mesh, jitter: float) -> None:
    """Add ``jitter`` times the global mean diagonal to the diagonals in
    ``diag_views`` (this rank's share of the diagonal, every entry once)."""
    total = torch.stack([d.sum() for d in diag_views]).sum() if diag_views else torch.zeros((), dtype=torch.float64)
    total = mesh.all_reduce(total.to(device=mesh.device, dtype=torch.float64).reshape(1))
    bump = jitter * float(total[0]) / n
    for d in diag_views:
        d.add_(bump)


def _factor_block(d: torch.Tensor, k: int) -> torch.Tensor:
    """Lower factor of the symmetrized diagonal block ``k``; ``LinAlgError``
    if it is not positive definite (the JAX package carries NaNs on)."""
    l_d, info = torch.linalg.cholesky_ex(0.5 * (d + d.T))
    if int(info) != 0:
        raise torch.linalg.LinAlgError(
            f"distributed Cholesky: diagonal block {k} is not positive definite (leading minor {int(info)})"
        )
    return l_d


def _factor_rows(A: BlockRows, jitter: float) -> BlockRows:
    """Right-looking blocked Cholesky of the symmetric ``A`` in place, on
    any block table (module docstring)."""
    a, nb, mesh, table = A.local, A.nb, A.mesh, A.table
    n, nblocks, bpr = A.n, table.size, table.shape[1]
    if jitter:
        _add_jitter([a[s * nb:(s + 1) * nb, g * nb:(g + 1) * nb].diagonal() for s, g in enumerate(A.blocks.tolist())],
                    n, mesh, jitter)
    for k in range(nblocks):
        kb, o, s = k * nb, int(A.owner[k]), int(A.slot[k])
        d = a[s * nb:(s + 1) * nb, kb:kb + nb].clone() if mesh.rank == o else a.new_empty((nb, nb))
        l_d = _factor_block(mesh.broadcast(d, o), k)
        if mesh.rank == o:
            a[s * nb:(s + 1) * nb, kb:kb + nb] = l_d
        f = A.first_after(k)
        pan = a[f * nb:, kb:kb + nb]
        if pan.shape[0]:
            pan.copy_(torch.linalg.solve_triangular(l_d.T, pan, upper=True, left=False))
        if k + 1 == nblocks:
            break
        # The panel rows below block k, each rank's padded to the most any
        # rank holds, gathered and put in natural order.
        counts = (table > k).sum(1)
        H = int(counts.max())
        buf = a.new_zeros((H * nb, nb))
        if pan.shape[0]:
            buf[(H - pan.shape[0] // nb) * nb:] = pan
        gathered = mesh.all_gather(buf).reshape(-1, nb, nb)
        t = np.arange(k + 1, nblocks)
        pos = A.owner[t] * H + H - bpr + A.slot[t]
        l_tail = gathered[torch.as_tensor(pos, device=a.device)].reshape(-1, nb)
        if pan.shape[0]:
            a[f * nb:, kb + nb:].addmm_(pan, l_tail.T, alpha=-1.0)
    for s, g in enumerate(A.blocks.tolist()):  # the strict upper triangle
        a[s * nb:(s + 1) * nb, (g + 1) * nb:] = 0.0
    return A


def _factor_1d(gram, mesh: Mesh, block_size: int, jitter, table_of) -> BlockRows:
    n, nb = _size(gram), int(block_size)
    _check_n(n, mesh.size * nb, "P*nb")
    table = table_of(n // nb, mesh.size)
    A = BlockRows(_rows_of(gram, mesh, table[mesh.rank], nb), table, nb, mesh)
    return _factor_rows(A, config.cholesky_jitter if jitter is None else jitter)


def distributed_cholesky(gram, *, mesh: Mesh, block_size: int = 512, jitter: float | None = None,
                         unroll: bool | None = None) -> BlockRows:
    """Lower Cholesky factor of an SPD matrix in contiguous row slabs
    (``cholesky.py:38-165`` of the JAX package).

    ``gram``: the ``(n, n)`` matrix (a tensor or array, each rank takes its
    rows) or a callable ``gram(rows, cols)`` of index tensors with the size
    as ``gram.n``; ``n`` must be divisible by ``P * block_size``.
    ``jitter`` (``None``: ``config.cholesky_jitter``) times the mean
    diagonal is added first.  Raises ``torch.linalg.LinAlgError`` where a
    pivot block is not positive definite.  ``unroll`` is accepted and
    changes nothing (module docstring)."""
    del unroll
    return _factor_1d(gram, mesh, block_size, jitter, contiguous_table)


def distributed_cholesky_cyclic(gram, *, mesh: Mesh, block_size: int = 512, jitter: float | None = None,
                                unroll: bool | None = None) -> BlockRows:
    """Block-cyclic distributed Cholesky (``cholesky.py:186-306`` of the JAX
    package): row block ``g`` on rank ``g mod P``, so the active rows shrink
    evenly over the ranks (``n^3 / (3P)`` flops each).  Arguments as
    :func:`distributed_cholesky`; the factor stays in the cyclic table."""
    del unroll
    return _factor_1d(gram, mesh, block_size, jitter, cyclic_table)


def _size(gram) -> int:
    return int(gram.n) if callable(gram) else int(torch.as_tensor(gram).shape[0])


def table_2d(nblocks: int, Pr: int, Pc: int) -> np.ndarray:
    """Row-block table of a 2-D factor regathered along ``cols``: rank
    ``(r, c)`` holds blocks ``t P + c Pr + r``."""
    P = Pr * Pc
    out = np.empty((P, nblocks // P), np.int64)
    for r in range(Pr):
        for c in range(Pc):
            out[r * Pc + c] = np.arange(nblocks // P) * P + c * Pr + r
    return out


def distributed_cholesky_2d(gram, *, mesh: Mesh, block_size: int = 256, jitter: float | None = None,
                            unroll: bool | None = None) -> BlockRows:
    """2-D block-cyclic distributed Cholesky over a ``(rows: Pr, cols: Pc)``
    mesh with ``Pr | Pc`` (``cholesky.py:309-535`` of the JAX package):
    block ``(i, j)`` on rank ``(i mod Pr, j mod Pc)``; per step the
    diagonal block is broadcast, the owning column solves its panel rows,
    the row route (along ``cols``) and the transpose route (along ``rows``:
    ``j = c mod Pc`` implies ``j = c mod Pr``) bring the panel blocks each
    rank's rows and columns need, O(n nb / Pr) a rank, and the trailing
    update is one local GEMM.  Returns the factor regathered along ``cols``
    into row blocks (:func:`table_2d`).  ``n`` must be divisible by
    ``nb * Pc``; other arguments as :func:`distributed_cholesky`."""
    del unroll
    if len(mesh.axis_names) != 2:
        raise ValueError("distributed_cholesky_2d needs a 2-D mesh")
    rn, cn = mesh.axis_names
    Pr, Pc = mesh.shape[rn], mesh.shape[cn]
    if Pc % Pr:
        raise ValueError(f"mesh cols ({Pc}) must be a multiple of rows ({Pr})")
    n, nb = _size(gram), int(block_size)
    _check_n(n, nb * Pc, "nb*Pc")
    nblocks = n // nb
    r, c = mesh.coords[rn], mesh.coords[cn]
    bpr, bpc, m_ratio = nblocks // Pr, nblocks // Pc, Pc // Pr
    row_blocks = np.arange(bpr) * Pr + r
    col_blocks = np.arange(bpc) * Pc + c
    cols = torch.as_tensor((col_blocks[:, None] * nb + np.arange(nb)).reshape(-1), device=mesh.device)
    a = _rows_of(gram, mesh, row_blocks, nb, cols)

    def first_after(k, coord, P_axis):  # slots along an axis whose block exceeds k
        return (k - coord) // P_axis + 1 if k >= coord else 0

    jitter = config.cholesky_jitter if jitter is None else jitter
    if jitter:
        views = []
        for s, i in enumerate(row_blocks.tolist()):
            if i % Pc == c:
                views.append(a[s * nb:(s + 1) * nb, (i // Pc) * nb:(i // Pc + 1) * nb].diagonal())
        _add_jitter(views, n, mesh, jitter)
    for k in range(nblocks):
        kr, kc = k % Pr, k % Pc
        sr, sc = k // Pr, k // Pc
        owner = (r, c) == (kr, kc)
        d = a[sr * nb:(sr + 1) * nb, sc * nb:(sc + 1) * nb].clone() if owner else a.new_empty((nb, nb))
        l_d = _factor_block(mesh.broadcast(d, kr * Pc + kc), k)
        fr = first_after(k, r, Pr)
        if c == kc:
            if owner:
                a[sr * nb:(sr + 1) * nb, sc * nb:(sc + 1) * nb] = l_d
            pan = a[fr * nb:, sc * nb:(sc + 1) * nb]
            if pan.shape[0]:
                pan.copy_(torch.linalg.solve_triangular(l_d.T, pan, upper=True, left=False))
        if k + 1 == nblocks:
            break
        # Row route: the panel rows of my row coordinate, from column kc.
        row_pan = a[fr * nb:, sc * nb:(sc + 1) * nb].clone() if c == kc else a.new_empty(((bpr - fr) * nb, nb))
        if row_pan.shape[0]:
            mesh.broadcast(row_pan, kc, cn)
        # Transpose route: my column blocks j > k sit at row coordinate c mod Pr.
        rs = c % Pr
        frs = first_after(k, rs, Pr)
        col_src = row_pan.clone() if r == rs else a.new_empty(((bpr - frs) * nb, nb))
        if col_src.shape[0]:
            mesh.broadcast(col_src, rs, rn)
        fc = first_after(k, c, Pc)
        if row_pan.shape[0] and fc < bpc:
            src = np.arange(fc, bpc) * m_ratio + c // Pr - frs
            l_col = col_src.reshape(-1, nb, nb)[torch.as_tensor(src, device=a.device)].reshape(-1, nb)
            a[fr * nb:, fc * nb:].addmm_(row_pan, l_col.T, alpha=-1.0)
    col_ids = torch.as_tensor(col_blocks, device=a.device).repeat_interleave(nb)
    for s, i in enumerate(row_blocks.tolist()):  # the strict upper triangle, by blocks
        a[s * nb:(s + 1) * nb, col_ids > i] = 0.0
        j = np.nonzero(col_blocks == i)[0]
        if j.size:
            blk = a[s * nb:(s + 1) * nb, int(j[0]) * nb:(int(j[0]) + 1) * nb]
            blk.copy_(torch.tril(blk))
    return _regather_2d(a, mesh, nblocks, nb, Pr, Pc, col_blocks)


def _regather_2d(a, mesh, nblocks, nb, Pr, Pc, col_blocks) -> BlockRows:
    """The 2-D tiles as row blocks: rank ``(r, c)`` keeps its row slots
    ``t Pc + c``, whole (:func:`table_2d`), gathered along ``cols``."""
    rn, cn = mesh.axis_names
    r, c = mesh.coords[rn], mesh.coords[cn]
    table = table_2d(nblocks, Pr, Pc)
    if Pc == 1:  # the tiles are whole rows already, in the table's order
        return BlockRows(a, table, nb, mesh)
    n = nblocks * nb
    kept = nblocks // (Pr * Pc)
    out = a.new_empty((kept * nb, n))
    cols_all = torch.as_tensor(((np.arange(nblocks // Pc)[None, :] * Pc + np.arange(Pc)[:, None])[:, :, None] * nb
                                + np.arange(nb)).reshape(Pc, -1), device=a.device)
    for t in range(kept):
        chunk = a[t * Pc * nb:(t + 1) * Pc * nb]  # my row slots t Pc .. t Pc + Pc - 1
        parts = mesh.all_gather(chunk, cn).reshape(Pc, Pc * nb, -1)  # [member c', slot, cols of c']
        for cc in range(Pc):
            out[t * nb:(t + 1) * nb, cols_all[cc]] = parts[cc, c * nb:(c + 1) * nb]
    return BlockRows(out, table, nb, mesh)


def _as_rows(chol, mesh: Mesh, block_size: int) -> BlockRows:
    """A factor as :class:`BlockRows`: as it is, or a full ``(n, n)`` tensor
    split into contiguous slabs of ``block_size`` blocks."""
    if isinstance(chol, BlockRows):
        return chol
    n, nb = _size(chol), int(block_size)
    _check_n(n, mesh.size * nb, "P*nb")
    table = contiguous_table(n // nb, mesh.size)
    return BlockRows(_rows_of(chol, mesh, table[mesh.rank], nb), table, nb, mesh)


def _tri_solve(L: BlockRows, r: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``L y = r`` (or ``L^T y = r``) for a replicated ``(n, m)`` ``r``;
    replicated result (module docstring)."""
    nb, mesh, a = L.nb, L.mesh, L.local
    nblocks, m = L.table.size, r.shape[1]
    out = torch.zeros_like(r)
    if not transpose:
        acc = a.new_zeros((a.shape[0], m))
        for k in range(nblocks):
            kb, o, s = k * nb, int(L.owner[k]), int(L.slot[k])
            if mesh.rank == o:
                l_kk = a[s * nb:(s + 1) * nb, kb:kb + nb]
                y_k = torch.linalg.solve_triangular(l_kk, r[kb:kb + nb] - acc[s * nb:(s + 1) * nb], upper=False)
            else:
                y_k = r.new_empty((nb, m))
            out[kb:kb + nb] = mesh.broadcast(y_k.contiguous(), o)
            f = L.first_after(k)
            if f < len(L.blocks):
                acc[f * nb:].addmm_(a[f * nb:, kb:kb + nb], out[kb:kb + nb])
        return out
    diag = L.diag_blocks()
    x_loc = a.new_zeros((a.shape[0], m))
    for k in range(nblocks - 1, -1, -1):
        kb, f = k * nb, L.first_after(k)
        s_k = a[f * nb:, kb:kb + nb].T @ x_loc[f * nb:]
        mesh.all_reduce(s_k)
        x_k = torch.linalg.solve_triangular(diag[k].T, r[kb:kb + nb] - s_k, upper=True)
        out[kb:kb + nb] = x_k
        if L.owner[k] == mesh.rank:
            s = int(L.slot[k])
            x_loc[s * nb:(s + 1) * nb] = x_k
    return out


def distributed_tri_solve(chol, rhs, *, mesh: Mesh, block_size: int = 512, transpose: bool = False) -> torch.Tensor:
    """Solve ``L y = rhs`` (or ``L^T y = rhs`` with ``transpose=True``) with
    the distributed lower factor ``L`` (``cholesky.py:538-641`` of the JAX
    package).  ``chol``: a :class:`BlockRows` factor (its own block size) or
    a full ``(n, n)`` tensor (split in contiguous slabs of
    ``block_size``); ``rhs``: ``(n,)`` or ``(n, m)``, the same on every
    rank.  Returns ``y`` on every rank, on the mesh's device."""
    L = _as_rows(chol, mesh, block_size)
    r = torch.as_tensor(rhs).to(device=mesh.device, dtype=L.local.dtype)
    vector = r.ndim == 1
    out = _tri_solve(L, r[:, None] if vector else r, transpose)
    return out[:, 0] if vector else out


def distributed_chol_solve(chol, rhs, *, mesh: Mesh, block_size: int = 512) -> torch.Tensor:
    """Solve ``(L L^T) x = rhs`` with the distributed factor ``L``
    (``cholesky.py:644-733`` of the JAX package); arguments as
    :func:`distributed_tri_solve`, ``rhs`` ``(n,)`` or ``(n, m)``."""
    L = _as_rows(chol, mesh, block_size)
    r = torch.as_tensor(rhs).to(device=mesh.device, dtype=L.local.dtype)
    vector = r.ndim == 1
    r2 = r[:, None] if vector else r
    out = _tri_solve(L, _tri_solve(L, r2, False), True)
    return out[:, 0] if vector else out
