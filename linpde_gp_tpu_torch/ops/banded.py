"""Banded Gram matvec for compactly supported (Wendland) kernels.

Port of the compact-support part of ``linpde_gp_tpu/ops/pallas_gram.py``
(``compact_support_radius`` ``:608``, ``band_windows`` ``:747``,
``make_banded_matvec`` ``:767``).  A kernel whose every term vanishes
beyond a radius along input dimension 0 has an exactly banded Gram once
the points are sorted by that dimension, so each block of sorted rows
needs only the columns within the radius of its rows: O(n0 * band) pair
work instead of O(n0 * n1), and exact, not an approximation.

The schedule is built on the host, in numpy, as in the JAX package: both
point sets are sorted by dimension 0 (stable argsort), and every block of
``config.matvec_tile`` sorted rows gets its own column window ``[lo, hi)``
in sorted columns, found by ``searchsorted`` in float64.  The TPU needed
one uniform band width and a clamped window start to keep its grid
static; the card does not, so each block walks only its own window.  Each
window is widened by a few float32 ulps of the coordinate scale: the f32
bodies round ``t = scale * |d|``, so a pair just beyond the radius can
evaluate as inside (with the Horner rounding residue ``~eps * sum|c|``, not
0), and the band must hold every pair the dense kernel would count.

Routing: a CUDA tensor launches the hand-written kernel of
``csrc/banded.cuh``, which replaces both TPU kernels (the multi-RHS
``_build_banded_matvec`` and the r = 1 panel ``_build_banded_panel_matvec``);
a CPU tensor takes the plain PyTorch version :func:`banded_matvec_plain`,
the same block-by-window algorithm.  There is no other route and no
fallback.  The permutation gathers are torch index ops outside the kernel.
In mode ff the result is the ff pair ``(hi, lo)``, as for
``ops/gram.gram_matvec``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_mode
from .ff import ff_split
from .gram import _as_points, _as_rhs, _collapse_terms, _eval_block

#: Float32 ulps of the coordinate scale each window is widened by.
_WIDEN_ULPS = 8


def compact_support_radius(terms, dim: int = 0) -> float | None:
    """Support radius along input dimension ``dim`` if every term's
    ``dim`` factor is compactly supported (``wendland``: ``|d| <= 1/scale``);
    ``None`` otherwise."""
    radius = 0.0
    for _coeff, factors in terms:
        f = factors[dim]
        if f[0] != "wendland":
            return None
        radius = max(radius, 1.0 / float(f[1]))
    return radius


def band_windows(c0_sorted, c1_sorted, radius: float, tile: int) -> np.ndarray:
    """``(ceil(n0 / tile), 2)`` column windows ``[lo, hi)`` into the sorted
    columns, one per block of ``tile`` sorted rows: every column within
    ``radius`` (widened by :data:`_WIDEN_ULPS` f32 ulps of the coordinate
    scale) of a row of the block.  ``c0_sorted`` / ``c1_sorted``: sorted
    dimension-0 coordinates, compared in float64."""
    c0 = np.asarray(c0_sorted, np.float64)
    c1 = np.asarray(c1_sorted, np.float64)
    n0 = c0.shape[0]
    nblocks = -(-n0 // tile)
    if nblocks == 0:
        return np.zeros((0, 2), np.int64)
    scale = max(float(np.max(np.abs(c0), initial=0.0)), float(np.max(np.abs(c1), initial=0.0)))
    reach = radius + _WIDEN_ULPS * float(np.finfo(np.float32).eps) * (radius + scale)
    first = c0[::tile]
    last = c0[np.minimum(np.arange(1, nblocks + 1) * tile, n0) - 1]
    lo = np.searchsorted(c1, first - reach, "left")
    hi = np.searchsorted(c1, last + reach, "right")
    return np.stack([lo, np.maximum(hi, lo)], axis=1).astype(np.int64)


def band_tile_counts(windows: np.ndarray, n1: int, tile: int) -> tuple[int, int]:
    """``(band_tiles, total_tiles)``: the most ``tile``-aligned column
    tiles one row block's window touches, and the column tiles in all, as
    the JAX package counts them (its routing rule compares the two)."""
    total = -(-n1 // tile)
    if windows.shape[0] == 0 or total == 0:
        return 0, total
    lo, hi = windows[:, 0], windows[:, 1]
    band = np.maximum(hi - 1, lo) // tile - lo // tile + 1
    return int(np.max(band)), total


def banded_matvec_plain(spec, X0s, X1s, v, windows, tile: int, mode=None, v_lo=None):
    """Plain PyTorch version of the banded kernel, on any device:
    ``scale * K(X0s, X1s) @ v`` with each block of ``tile`` sorted rows
    evaluated against only its column window (``windows``, as
    :func:`band_windows` returns).  ``v``: ``(n1, r)`` in the sorted column
    order; mode ff takes its lo plane as ``v_lo``, forms the product with
    the ff entries and the sum in float64 (the kernel carries them in ff)
    and returns the ff pair ``(hi, lo)``."""
    mode = resolve_mode(mode)
    scale, terms = spec
    groups = _collapse_terms(tuple(terms))
    n0 = X0s.shape[0]
    if mode == "ff":
        v = v.double() if v_lo is None else v.double() + v_lo.double()
    out = torch.zeros((n0, v.shape[1]), dtype=v.dtype, device=X0s.device)
    for b, (lo, hi) in enumerate(np.asarray(windows).tolist()):
        if hi <= lo:
            continue
        rows = slice(b * tile, min((b + 1) * tile, n0))
        blk = _eval_block(groups, X0s[rows], X1s[lo:hi], mode)
        if mode == "ff":
            blk = blk[0].double() + blk[1].double()
        out[rows] = blk @ v[lo:hi]
    if scale != 1.0:
        out = scale * out
    return ff_split(out) if mode == "ff" else out


class BandedMatvec:
    """``v -> scale * K(X0, X1) @ v`` over the band of a compactly
    supported spec; takes and returns vectors in the original point
    order (see :func:`make_banded_matvec`).

    ``band_tiles`` / ``total_tiles``: the widest window in
    ``config.matvec_tile``-wide column tiles, and the column tiles in all;
    the banded route pays off only if ``band_tiles < total_tiles``.
    """

    def __init__(self, spec, X0, X1, *, radius: float | None, mode: str):
        self.mode = resolve_mode(mode)
        self.spec = spec
        scale, terms = spec
        if radius is None:
            radius = compact_support_radius(terms, 0)
            if radius is None:
                raise ValueError("kernel is not compactly supported along dim 0; pass radius=")
        self.radius = float(radius)
        self._groups = _collapse_terms(tuple(terms))
        X0, X1 = _as_points(X0, self.mode), _as_points(X1, self.mode)
        if X0.device != X1.device:
            raise ValueError(f"X0 on {X0.device}, X1 on {X1.device}")
        self.device = X0.device
        self.tile = int(config.matvec_tile)
        c0 = X0[:, 0].to("cpu", torch.float64).numpy()
        c1 = X1[:, 0].to("cpu", torch.float64).numpy()
        perm0 = np.argsort(c0, kind="stable")
        perm1 = np.argsort(c1, kind="stable")
        self.windows = band_windows(c0[perm0], c1[perm1], self.radius, self.tile)
        self.band_tiles, self.total_tiles = band_tile_counts(self.windows, X1.shape[0], self.tile)
        rows = np.diff(np.minimum(np.arange(self.windows.shape[0] + 1) * self.tile, X0.shape[0]))
        #: Share of the (n0, n1) pairs the kernel evaluates.
        self.pair_fraction = float(np.sum((self.windows[:, 1] - self.windows[:, 0]) * rows)) / max(
            X0.shape[0] * X1.shape[0], 1
        )
        self._perm1 = torch.as_tensor(perm1, device=self.device)
        self._inv0 = torch.as_tensor(np.argsort(perm0, kind="stable"), device=self.device)
        self.X0s = X0[torch.as_tensor(perm0, device=self.device)].contiguous()
        self.X1s = X1[self._perm1].contiguous()
        self._windows_dev = torch.as_tensor(self.windows.astype(np.int32), device=self.device)

    def _sorted_rhs(self, v):
        (hi, lo), vector = _as_rhs(v, self.X1s, self.mode)
        hi = hi[self._perm1].contiguous()
        lo = None if lo is None else lo[self._perm1].contiguous()
        return hi, lo, vector

    def _finish(self, out_sorted, vector):
        def unsort(o):
            o = o[self._inv0]
            return o[:, 0] if vector else o

        if self.mode != "ff":
            return unsort(out_sorted)
        return unsort(out_sorted[0]), unsort(out_sorted[1])

    def __call__(self, v):
        """``v``: ``(n1,)`` or ``(n1, r)``, or in mode ff also an ff pair
        ``(hi, lo)`` of those; mode ff returns the ff pair of the result.
        CUDA tensors launch the kernel; CPU tensors take
        :func:`banded_matvec_plain`."""
        if self.device.type == "cuda":
            from . import _cuda

            hi, lo, vector = self._sorted_rhs(v)
            out = _cuda.banded_matvec(self._groups, self.X0s, self.X1s, hi, self._windows_dev, self.tile, self.mode,
                                      lo, scale=self.spec[0])
            return self._finish(out, vector)
        if self.device.type != "cpu":
            raise ValueError(f"no route for device {self.device}")
        return self.plain(v)

    def plain(self, v):
        """The plain version on the points' device (the kernel's oracle)."""
        hi, lo, vector = self._sorted_rhs(v)
        out = banded_matvec_plain(self.spec, self.X0s, self.X1s, hi, self.windows, self.tile, self.mode, lo)
        return self._finish(out, vector)


def make_banded_matvec(spec, X0, X1, *, radius: float | None = None, mode=None) -> BandedMatvec:
    """Banded gram-free matvec ``v -> scale * K(X0, X1) @ v`` for a
    ``(scale, terms)`` spec that is compactly supported along dimension 0.

    ``X0`` / ``X1``: ``(n, d)`` points (``(n,)`` means ``d = 1``), stored in
    the mode's dtype, a tensor on its device and numpy input on the default
    device (``config.resolve_device``).
    ``radius`` defaults to the spec's Wendland support along dimension 0;
    a spec without one raises ``ValueError``.
    """
    return BandedMatvec(spec, X0, X1, radius=radius, mode=mode)


__all__ = [
    "BandedMatvec",
    "band_tile_counts",
    "band_windows",
    "banded_matvec_plain",
    "compact_support_radius",
    "make_banded_matvec",
]
