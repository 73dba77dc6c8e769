"""Float-float ("double-single") arithmetic on torch tensors.

Port of ``linpde_gp_tpu/ops/ff.py``.  A value is an unevaluated pair
``(hi, lo)`` of tensors of one dtype with ``hi + lo`` accurate to about
``eps**2``.  The building blocks are error-free transformations (Knuth
two-sum, Dekker split and two-product), exact under plain IEEE
arithmetic as long as nothing contracts a multiply and an add into one
FMA: every function here is a sequence of separate elementwise torch
ops, each rounded on its own.  The CUDA kernels carry the same
functions in ``csrc/ff.cuh``.

These run on any device.  They are the plain version of the
float-float kernel body (``ops/gram.py``) and the arithmetic of the
float-float CG vectors (``ops/linalg/pcg.py``); the last section, how
each arithmetic mode carries the gram-free CG's vectors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import mode_dtype

__all__ = [
    "two_sum",
    "quick_two_sum",
    "two_diff",
    "two_prod",
    "ff_add",
    "ff_add_const",
    "ff_mul",
    "ff_sqr",
    "ff_neg",
    "ff_abs",
    "ff_scale",
    "ff_exp",
    "ff_const",
    "ff_split",
    "state_dtype",
    "aux_mode",
    "to_carrier",
    "operand",
    "read_back",
    "planewise",
]


def _splitter(dtype) -> float:
    # 2**ceil(p/2) + 1 for a p-bit mantissa: 4097 (f32), 134217729 (f64).
    return 4097.0 if dtype == torch.float32 else 134217729.0


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e, requiring |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def two_diff(a, b):
    """Error-free a - b = s + e."""
    s = a - b
    bb = s - a
    e = (a - (s - bb)) - (b + bb)
    return s, e


def _split(a):
    c = _splitter(a.dtype) * a
    big = c - a
    hi = c - big
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker; exact without FMA).

    ``b`` may be a Python float; it is rounded to ``a``'s dtype first so
    that the split halves are narrow enough for exact products.
    """
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- float-float pairs (hi, lo) ---------------------------------------------
# Pairs are kept unnormalized, as in the JAX package: |lo| may grow to a
# few ulps of hi over a chain, which stays far below the accuracy target.


def ff_add(x, y):
    s, e = two_sum(x[0], y[0])
    return s, e + (x[1] + y[1])


def ff_add_const(x, c_hi: float, c_lo: float):
    s, e = two_sum(x[0], c_hi)
    return s, e + (x[1] + c_lo)


def ff_mul(x, y):
    p, e = two_prod(x[0], y[0])
    return p, e + (x[0] * y[1] + x[1] * y[0])


def ff_sqr(x):
    p, e = two_prod(x[0], x[0])
    return p, e + 2.0 * (x[0] * x[1])


def ff_neg(x):
    return (-x[0], -x[1])


def ff_abs(x):
    s = torch.where(x[0] < 0, -1.0, 1.0).to(x[0].dtype)
    return (x[0] * s, x[1] * s)


def ff_const(c: float, dtype):
    """Split a Python float into an (hi, lo) pair for ``dtype``, on the
    host in float64."""
    if dtype == torch.float32:
        hi = float(np.float32(c))
        lo = float(np.float32(c - hi))
    else:
        hi, lo = float(c), 0.0
    return hi, lo


def ff_split(x, dtype=torch.float32):
    """A wider (float64) tensor as the ff pair ``(hi, lo)`` of ``dtype``
    tensors: ``hi`` its rounding, ``lo`` the rounding of the rest."""
    hi = x.to(dtype)
    return hi, (x - hi.to(x.dtype)).to(dtype)


def ff_scale(x, scale: float):
    """Multiply an ff pair by an exact Python float (split per dtype)."""
    s_hi, s_lo = ff_const(scale, x[0].dtype)
    p, e = two_prod(x[0], s_hi)
    return p, e + (x[0] * s_lo + x[1] * s_hi)


# -- exp ---------------------------------------------------------------------

_LN2 = 0.6931471805599453094172321
_LOG2E = 1.4426950408889634073599247
# Taylor 1/k!, k = 0..10: relative truncation error <= 0.347**11/11! ~ 2e-13
# on the reduced range |r| <= ln2/2.
_EXP_COEFFS = [1.0 / float(math.factorial(k)) for k in range(11)]


def _exp2_int(kf):
    """Exact 2**k for integer-valued float ``kf`` via exponent bits."""
    if kf.dtype == torch.float32:
        return ((kf.to(torch.int32) + 127) << 23).view(torch.float32)
    return ((kf.to(torch.int64) + 1023) << 52).view(torch.float64)


def ff_exp(x):
    """``exp(x)`` of an ff pair, accurate to ~eps32**2 relatively.

    Range reduction ``x = k*ln2 + r`` with ``k*ln2`` carried error-free
    against the split ln2, a degree-10 Taylor Horner in ff on
    ``|r| <= ln2/2``, and exact ``2**k`` from exponent bits.  Arguments
    are clamped at the under/overflow edge (results there are ~1e-38,
    i.e. exactly-zero kernel tails).
    """
    dtype = x[0].dtype
    bound = 87.0 if dtype == torch.float32 else 708.0
    clamped = (x[0] < -bound) | (x[0] > bound)
    xh = torch.clamp(x[0], -bound, bound)
    xl = torch.where(clamped, torch.zeros_like(x[1]), x[1])

    kf = torch.floor(xh * _LOG2E + 0.5)
    ln2_hi, ln2_lo = ff_const(_LN2, dtype)
    ph, pe = two_prod(kf, ln2_hi)
    pe = pe + kf * ln2_lo
    # r = x - k*ln2 (ff; the leading two_sum cancels exactly).
    rh, re = two_sum(xh, -ph)
    r = (rh, re + (xl - pe))

    c_hi, c_lo = ff_const(_EXP_COEFFS[-1], dtype)
    acc = (torch.full_like(rh, c_hi), torch.full_like(rh, c_lo))
    for c in reversed(_EXP_COEFFS[:-1]):
        c_hi, c_lo = ff_const(c, dtype)
        acc = ff_add_const(ff_mul(acc, r), c_hi, c_lo)

    two_k = _exp2_int(kf)
    return (acc[0] * two_k, acc[1] * two_k)


# -- the mode's carrier ---------------------------------------------------------
# How each mode carries the gram-free CG's vectors: mode ff as ff pairs, read
# back as ``hi + lo`` in float64; plain and f64 as one tensor of the mode's
# dtype.  The state past the points' precision is float64 unless plain.


def state_dtype(mode: str) -> torch.dtype:
    """The solver's state past the points' precision: float64 unless plain."""
    return torch.float32 if mode == "plain" else torch.float64


def aux_mode(mode: str) -> str:
    """The mode of kernel blocks kept in :func:`state_dtype`: f64 unless plain."""
    return "plain" if mode == "plain" else "f64"


def to_carrier(x: torch.Tensor, mode: str):
    """A :func:`state_dtype` tensor as the CG's carrier: its ff pair in mode
    ff (split, not rounded), else in the mode's dtype."""
    return ff_split(x.double(), mode_dtype(mode)) if mode == "ff" else x.to(mode_dtype(mode))


def operand(v_ff, mode: str):
    """The kernels' operand of an ff pair: the pair in mode ff, else ``hi``."""
    return v_ff if mode == "ff" else v_ff[0]


def read_back(out, mode: str) -> torch.Tensor:
    """A kernel's result (or an :func:`operand`) as one tensor: ``hi + lo``
    in float64 in mode ff, else as it is."""
    return out[0].double() + out[1].double() if mode == "ff" else out


def planewise(fn, x):
    """``fn`` of a tensor, or of each plane of an ff pair."""
    return tuple(fn(p) for p in x) if isinstance(x, tuple) else fn(x)
