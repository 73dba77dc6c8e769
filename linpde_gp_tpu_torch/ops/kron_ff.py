"""Compensated sum-of-Kronecker Gram matvec on tensor-product grids.

Port of ``linpde_gp_tpu/ops/kron_ff.py``.  On a 2-factor
``TensorProductGrid`` the Gram of a ``(scale, terms)`` spec is ``scale *
sum_t c_t A_t (x) B_t`` with ``A_t`` the ``(n_t, n_t)`` table of the term's
dimension-0 factor and ``B_t`` the ``(n_x, n_x)`` table of its dimension-1
factor, so a matvec costs O(N (n_t + n_x)) instead of K2's O(N^2).  In
float32 that structure is unusable at honest noise: the heat ``H k H*``
terms cancel heavily, and the JAX package measured ``||E v|| / ||v|| ~
7e-2`` at a (200, 100) grid with plain float32 tables and GEMMs, 140 times
a 1e-3 relative nugget.  Two compensation layers, as there:

1. The factor tables are evaluated on the host in float64
   (:func:`eval_factor_np`) and split into float-float pairs (hi, lo) of
   float32.
2. Every GEMM against a hi table is split along its contraction into
   chunks of ``chunk`` columns, whose float32 partial products are
   combined by the error-free ``two_sum`` of ``ops/ff.py``; the products
   with the lo planes are added in the low word.  The float32 sum inside
   each chunk's GEMM is what is left of the error, so the chunk is 32, not
   the JAX package's 64: on the 96 x 48 heat grid of
   ``tests/test_torch_kron_ff.py`` torch's float32 GEMMs (CPU) err by
   2.6e-6 ||v|| at 64 and 1.9e-6 at 32, where the JAX package's matvec
   errs by 2.2e-6.

Two departures from the JAX package, for the reasons K2's ff route has
them (ROADMAP Queue 3): the matvec takes the CG's ff pair ``(v_hi, v_lo)``
(JAX takes ``v`` in float32, ``kron_ff.py:129``), and it returns the ff
pair of the result (JAX rounds ``hi + lo`` to float32, ``:161``).

The terms' tables are stacked, so a matvec takes a fixed number of
launches whatever the number of terms: ``[A_1; ...; A_T] V`` contracts the
t axis of all terms in one GEMM per chunk, a batched GEMM per chunk
contracts each term's x axis against its ``B_t``, and the terms are summed
in ff by ``two_sum`` in a tree over the stacked axis.  The terms cancel
heavily, so they are never summed inside one float32 GEMM: that loses a
third of the accuracy on the heat kernel.  These are plain GEMMs (cuBLAS
on the card, float32 without TF32), as they are plain XLA GEMMs outside
any Pallas kernel in the JAX package.

The regressor no longer takes this matvec: its float32 sums inside each
chunk err by ~7e-6 ||v|| on the 500 x 200 heat grid, which left the grid's
ff variance 1.6e-4 of max var off float64's on an H100 (80GB HBM3, 700 W),
where the float64 Kronecker operator of :func:`kron_linop` is exact and
faster (0.43 against 3.22 ms at r = 1, 4.67 against 80.1 ms at r = 256).
Mode ff's grid CG takes that operator's ff split (``models/iterative.py``);
this class stays as the port of the JAX module, with its parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .ff import two_sum
from .linalg.linops import Dense, Kronecker, SumOperator


def eval_factor_np(spec, d):
    """Float64 numpy evaluation of one univariate factor ``(kind, scale,
    poly, parity, prefactor)`` of a term spec at differences ``d``
    (``kron_ff.py:42`` of the JAX package, which has no ``"wendland"``
    kind: there a Wendland grid takes the float32 linop)."""
    kind, scale, poly, parity, prefactor = spec
    d = np.asarray(d, np.float64)
    if kind == "matern":
        t = float(scale) * np.abs(d)
        res = np.full_like(t, float(poly[-1]))
        for c in reversed(poly[:-1]):
            res = res * t + float(c)
        val = res * np.exp(-t)
        if parity:
            val = val * np.sign(d)
    elif kind == "expquad":
        z = float(scale) * d
        res = np.full_like(z, float(poly[-1]))
        for c in reversed(poly[:-1]):
            res = res * z + float(c)
        val = res * np.exp(-(z * z))
    elif kind == "wendland":
        t = float(scale) * np.abs(d)
        res = np.full_like(t, float(poly[-1]))
        for c in reversed(poly[:-1]):
            res = res * t + float(c)
        val = np.where(t <= 1.0, res, 0.0)
        if parity:
            val = val * np.sign(d)
    else:
        raise ValueError(f"unknown factor kind {kind!r}")
    return float(prefactor) * val


def _ff_split(a64: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A float64 array as the float32 ff pair ``(hi, lo)`` on ``device``."""
    hi = a64.astype(np.float32)
    lo = (a64 - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def _chunked_ff_matmul(X, Y, chunk: int):
    """``X @ Y`` of two float32 ff pairs, ``X`` ``(..., m, k)`` and ``Y``
    ``(..., k, r)``, as an ff pair (``kron_ff.py:69`` of the JAX package):
    the hi x hi product in chunks of ``chunk`` along k, combined by
    ``two_sum``; the hi x lo and lo x hi products in the low word (lo x lo,
    ~eps^2 of the result, is dropped)."""
    (X_hi, X_lo), (Y_hi, Y_lo) = X, Y
    k = X_hi.shape[-1]
    s = X_hi[..., :chunk] @ Y_hi[..., :chunk, :]
    c = torch.zeros_like(s)
    for start in range(chunk, k, chunk):
        s, e = two_sum(s, X_hi[..., start:start + chunk] @ Y_hi[..., start:start + chunk, :])
        c = c + e
    return s, c + (X_hi @ Y_lo + X_lo @ Y_hi)


def _ff_sum0(s, c):
    """The ff sum over the leading axis of the ff pair ``(s, c)``: a tree of
    ``two_sum``s, one launch per level."""
    while s.shape[0] > 1:
        half = s.shape[0] // 2
        h, e = two_sum(s[:half], s[half:2 * half])
        lo = e + (c[:half] + c[half:2 * half])
        if s.shape[0] % 2:
            h, lo = torch.cat([h, s[-1:]]), torch.cat([lo, c[-1:]])
        s, c = h, lo
    return s[0], c[0]


class KronFFMatvec:
    """Compensated matvec of ``scale * sum_t c_t A_t (x) B_t`` on a 2-factor
    tensor-product grid, with grid points in C order (row ``t * n_x + x``).

    Built from a ``kernel_term_specs`` spec and the host grid factors (read
    in float64); the ff tables live on ``device`` (``None``: the default
    device).  Calls map a float32 tensor or ff pair of shape ``(n,)`` or
    ``(n, r)`` to the ff pair ``(hi, lo)`` of the product, ``hi`` its float32
    rounding.  CUDA tensors run the GEMMs on the card; CPU tensors on the
    host, in the same order.
    """

    def __init__(self, spec, grid_factors, *, device=None, chunk: int = 32):
        scale, terms = spec
        factors64 = [np.asarray(g, np.float64).reshape(-1) for g in grid_factors]
        if len(factors64) != 2:
            raise NotImplementedError("KronFFMatvec supports 2-factor grids, as the JAX package does")
        self.shape_factors = tuple(len(g) for g in factors64)
        self.n = int(np.prod(self.shape_factors))
        self.num_terms = len(terms)
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        d_t, d_x = (g[:, None] - g[None, :] for g in factors64)
        # (T n_t, n_t): the scaled dimension-0 tables stacked by rows.
        A = np.concatenate([float(scale) * float(c) * eval_factor_np(fs[0], d_t) for c, fs in terms])
        # (T, n_x, n_x): the transposed dimension-1 tables.
        Bt = np.stack([eval_factor_np(fs[1], d_x).T for _c, fs in terms])
        self.A = _ff_split(A, self.device)
        self.Bt = _ff_split(np.ascontiguousarray(Bt), self.device)

    def __call__(self, v):
        hi, lo = v if isinstance(v, tuple) else (v, torch.zeros_like(v))
        vector = hi.ndim == 1
        if vector:
            hi, lo = hi[:, None], lo[:, None]
        nt, nx = self.shape_factors
        T, r = self.num_terms, hi.shape[1]
        # Contract t for every term at once: (T n_t, n_t) @ (n_t, n_x r).
        W = _chunked_ff_matmul(self.A, (hi.reshape(nt, nx * r), lo.reshape(nt, nx * r)), self.chunk)
        # (T, n_t, n_x, r) -> (T, n_t r, n_x), then contract x per term.
        W = tuple(w.reshape(T, nt, nx, r).transpose(2, 3).reshape(T, nt * r, nx) for w in W)
        s, c = _ff_sum0(*_chunked_ff_matmul(W, self.Bt, self.chunk))
        out = tuple(y.reshape(nt, r, nx).transpose(1, 2).reshape(self.n, r) for y in two_sum(s, c))
        return (out[0][:, 0], out[1][:, 0]) if vector else out


def kron_linop(spec, grid_factors, grid_factors1=None, *, dtype=torch.float64, device=None):
    """The Gram of a ``(scale, terms)`` spec between tensor-product grids
    (any number of factors, points in C order; ``grid_factors1``: the
    second grid's, ``None`` for the first's) as the ``SumOperator`` of one
    ``Kronecker`` term per spec term, each distinct factor table evaluated
    once on the host in float64 (:func:`eval_factor_np`) and held in
    ``dtype`` on ``device``.  ``CovarianceFunction.linop`` builds its
    structured Grams here, and modes f64 and plain run the regressor's CG
    matvec through it."""
    scale, terms = spec
    device = resolve_device(device)
    f0 = [np.asarray(g, np.float64).reshape(-1) for g in grid_factors]
    f1 = f0 if grid_factors1 is None else [np.asarray(g, np.float64).reshape(-1) for g in grid_factors1]
    diffs = [g0[:, None] - g1[None, :] for g0, g1 in zip(f0, f1)]
    tables: dict = {}

    def table(i, fspec, c=1.0):
        """Factor ``i``'s table times ``c`` (scaled in float64)."""
        if (i, fspec, c) not in tables:
            tables[i, fspec, c] = Dense(torch.from_numpy(c * eval_factor_np(fspec, diffs[i])).to(device), dtype)
        return tables[i, fspec, c]

    ops = []
    for coeff, fspecs in terms:
        op = table(0, fspecs[0], float(scale) * float(coeff))
        for i, fspec in enumerate(fspecs[1:], start=1):
            op = Kronecker(op, table(i, fspec))
        ops.append(op)
    return ops[0] if len(ops) == 1 else SumOperator(*ops)
