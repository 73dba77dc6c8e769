"""Gram assembly (K1) and gram-free Gram matvec (K2) of sum-of-products
kernels.

Port of the main-path part of ``linpde_gp_tpu/ops/pallas_gram.py``.  A
spec's terms collapse into a few multivariate polynomial groups
(:func:`_collapse_terms`, copied from the JAX package); each pair of
points then costs one ``exp`` per distinct ``(dim, kind, scale)`` and a
nested Horner sweep per group.

Routing: a CUDA tensor goes to the hand-written kernels of
``csrc/gram.cu`` (through ``ops/_cuda.py``); a CPU tensor goes to the
plain PyTorch version in this module (:func:`gram_plain`,
:func:`gram_matvec_plain`).  There is no other route and no fallback.

Modes (``config.py``): ``"plain"`` (float32), ``"ff"`` (float32
float-float pairs, the JAX package's ``compensated=True``) and ``"f64"``
(float64).  The ff Gram stores ``hi + lo``.  The ff matvec takes ``v`` as
a tensor or as an ff pair ``(hi, lo)`` and carries every product and the
sum in ff.  It departs from the TPU kernel here, which summed ``hi * v``
and ``lo * v`` in f32. At N = 1e5 and noise 1e-3 these sums cancel by
~5e7, and the f32 sum left CG unable to converge (PERF.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import mode_dtype, resolve_mode
from . import ff

# A term spec is a tuple: (coeff, factors) with factors a tuple of
# (kind, scale, poly, parity, prefactor) per input dimension; kind is
# "matern" (t = scale*|d|, exp(-t)), "expquad" (z = scale*d, exp(-z^2))
# or "wendland" (t = scale*|d|, cut off at t > 1).
#: Elements of one (rows, n1) block the plain versions evaluate at once:
#: large on a card, cache-sized on a CPU.
_PLAIN_BLOCK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 16}


@functools.lru_cache(maxsize=None)
def _collapse_terms(terms: tuple) -> tuple:
    """Merge sum-of-products terms into multivariate polynomial groups.

    Terms whose factors share the same per-dimension ``(kind, scale)``
    and parity vector differ only in their polynomial parts, so their
    sum is ONE multivariate polynomial: the sum of outer products of the
    per-factor coefficient vectors (prefactors and the term coefficient
    folded in, accumulated in float64).

    Returns ``((dims_key, parity, coeff_tensor_nested_tuple), ...)``.
    """
    groups: dict = {}
    order: list = []
    for coeff, factors in terms:
        dims_key = tuple((f[0], float(f[1])) for f in factors)
        # Parity (an explicit sign(d) factor) applies to the |d|-variable
        # families (matern, wendland); expquad polynomials are in the
        # signed variable already.
        parity = tuple(
            int(f[3]) if f[0] in ("matern", "wendland") else 0 for f in factors
        )
        key = (dims_key, parity)
        c = float(coeff)
        tensor = np.asarray([1.0], dtype=np.float64)
        for f in factors:
            c *= float(f[4])
            tensor = np.multiply.outer(tensor, np.asarray(f[2], np.float64))
        tensor = c * tensor[0]
        if key not in groups:
            groups[key] = tensor
            order.append(key)
        else:
            prev = groups[key]
            shape = tuple(max(a, b) for a, b in zip(prev.shape, tensor.shape))
            merged = np.zeros(shape, np.float64)
            merged[tuple(slice(s) for s in prev.shape)] += prev
            merged[tuple(slice(s) for s in tensor.shape)] += tensor
            groups[key] = merged

    def nest(a):
        if a.ndim == 1:
            return tuple(float(v) for v in a)
        return tuple(nest(sub) for sub in a)

    return tuple((key[0], key[1], nest(groups[key])) for key in order)


# -- plain versions of the kernel bodies ---------------------------------------


def _horner_1d(coeffs, t):
    acc = torch.full_like(t, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * t + c
    return acc


def _horner_nd(C, ts, axis=0):
    """Nested Horner evaluation of a multivariate coefficient tensor."""
    if axis == len(ts) - 1:
        return _horner_1d(C, ts[axis])
    subs = [_horner_nd(sub, ts, axis + 1) for sub in C]
    acc = subs[-1]
    t = ts[axis]
    for s in reversed(subs[:-1]):
        acc = acc * t + s
    return acc


def _horner_1d_ff(coeffs, t):
    c_hi, c_lo = ff.ff_const(coeffs[-1], t[0].dtype)
    acc = (torch.full_like(t[0], c_hi), torch.full_like(t[0], c_lo))
    for c in reversed(coeffs[:-1]):
        c_hi, c_lo = ff.ff_const(c, t[0].dtype)
        acc = ff.ff_add_const(ff.ff_mul(acc, t), c_hi, c_lo)
    return acc


def _horner_nd_ff(C, ts, axis=0):
    if axis == len(ts) - 1:
        return _horner_1d_ff(C, ts[axis])
    subs = [_horner_nd_ff(sub, ts, axis + 1) for sub in C]
    acc = subs[-1]
    t = ts[axis]
    for s in reversed(subs[:-1]):
        acc = ff.ff_add(ff.ff_mul(acc, t), s)
    return acc


def _eval_groups(groups, d_fn):
    """Evaluate collapsed polynomial groups given per-dimension pairwise
    differences ``d_fn(i)``; transcendentals memoized across groups.
    The plain version of the plain and f64 kernel bodies."""
    d_cache: dict = {}
    t_cache: dict = {}
    e_cache: dict = {}
    s_cache: dict = {}

    def d(i):
        if i not in d_cache:
            d_cache[i] = d_fn(i)
        return d_cache[i]

    acc = None
    for dims_key, parity, C in groups:
        ts = []
        env = None
        for i, (kind, scale) in enumerate(dims_key):
            tk = (i, kind, scale)
            if tk not in t_cache:
                if kind == "matern":
                    t = scale * torch.abs(d(i))
                    e = torch.exp(-t)
                elif kind == "wendland":
                    t = scale * torch.abs(d(i))
                    e = (t <= 1.0).to(t.dtype)  # compact support cutoff
                else:
                    t = scale * d(i)
                    e = torch.exp(-(t * t))
                t_cache[tk] = t
                e_cache[tk] = e
            ts.append(t_cache[tk])
            env = e_cache[tk] if env is None else env * e_cache[tk]
        val = _horner_nd(C, ts) * env
        for i, p in enumerate(parity):
            if p:
                if i not in s_cache:
                    s_cache[i] = torch.sign(d(i))
                val = val * s_cache[i]
        acc = val if acc is None else acc + val
    return acc


def _eval_groups_ff(groups, d_fn):
    """Float-float variant of :func:`_eval_groups`: the plain version of
    the ff kernel body.

    ``d_fn(i)`` returns the RAW per-dimension operands ``(a_i, b_i)``
    (broadcastable); the difference, scaled distance, Horner chains,
    exponentials and term sum are carried in hi/lo pairs.  Returns the
    ``(hi, lo)`` pair.
    """
    d_cache: dict = {}
    t_cache: dict = {}
    e_cache: dict = {}
    s_cache: dict = {}

    def dff(i):
        if i not in d_cache:
            a, b = d_fn(i)
            d_cache[i] = ff.two_diff(a, b)
        return d_cache[i]

    acc = None
    for dims_key, parity, C in groups:
        ts = []
        env = None
        for i, (kind, scale) in enumerate(dims_key):
            tk = (i, kind, scale)
            if tk not in t_cache:
                z = ff.ff_scale(dff(i), scale)
                if kind == "matern":
                    t = ff.ff_abs(z)
                    e = ff.ff_exp(ff.ff_neg(t))
                elif kind == "wendland":
                    t = ff.ff_abs(z)
                    inside = (t[0] < 1.0) | ((t[0] == 1.0) & (t[1] <= 0.0))
                    e = (inside.to(t[0].dtype), torch.zeros_like(t[0]))
                else:
                    t = z
                    e = ff.ff_exp(ff.ff_neg(ff.ff_sqr(z)))
                t_cache[tk] = t
                e_cache[tk] = e
            ts.append(t_cache[tk])
            env = e_cache[tk] if env is None else ff.ff_mul(env, e_cache[tk])
        val = ff.ff_mul(_horner_nd_ff(C, ts), env)
        for i, p in enumerate(parity):
            if p:
                if i not in s_cache:
                    s_cache[i] = torch.sign(dff(i)[0])
                val = (val[0] * s_cache[i], val[1] * s_cache[i])
        acc = val if acc is None else ff.ff_add(acc, val)
    return acc


def _eval_block(groups, x0, x1, mode):
    """Kernel values of one (rows, cols) block: a tensor, or an ff pair."""
    if mode == "ff":
        return _eval_groups_ff(groups, lambda i: (x0[:, None, i], x1[None, :, i]))
    return _eval_groups(groups, lambda i: x0[:, None, i] - x1[None, :, i])


def _row_blocks(n0, n1, device):
    step = max(1, _PLAIN_BLOCK_ELEMS.get(device.type, 1 << 24) // max(n1, 1))
    return range(0, n0, step), step


def gram_plain(terms, X0, X1, mode=None) -> torch.Tensor:
    """Plain PyTorch version of K1 on any device, in row blocks."""
    mode = resolve_mode(mode)
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    groups = _collapse_terms(tuple(terms))
    n0, n1 = X0.shape[0], X1.shape[0]
    out = torch.empty((n0, n1), dtype=X0.dtype, device=X0.device)
    starts, step = _row_blocks(n0, n1, X0.device)
    for s in starts:
        blk = _eval_block(groups, X0[s:s + step], X1, mode)
        out[s:s + step] = blk[0] + blk[1] if mode == "ff" else blk
    return out


def gram_matvec_plain(spec, X0, X1, v, mode=None) -> torch.Tensor:
    """Plain PyTorch version of K2 (``scale * K(X0, X1) @ v``) on any
    device, in row blocks.  Mode ff takes ``v`` or an ff pair and forms
    the product of the ff entries with it in float64 (the kernel carries
    it in ff)."""
    mode = resolve_mode(mode)
    scale, terms = spec
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    (v, v_lo), vector = _as_rhs(v, X1, mode)
    if mode == "ff":
        v64 = v.double() if v_lo is None else v.double() + v_lo.double()
    groups = _collapse_terms(tuple(terms))
    n0, n1 = X0.shape[0], X1.shape[0]
    out = torch.empty((n0, v.shape[1]), dtype=X0.dtype, device=X0.device)
    starts, step = _row_blocks(n0, n1, X0.device)
    for s in starts:
        blk = _eval_block(groups, X0[s:s + step], X1, mode)
        out[s:s + step] = (blk[0].double() + blk[1].double()) @ v64 if mode == "ff" else blk @ v
    if scale != 1.0:
        out = scale * out
    return out[:, 0] if vector else out


# -- public entry points ---------------------------------------------------------


def _as_points(X, mode) -> torch.Tensor:
    """``(n, d)`` points in the mode's dtype (``(n,)`` means ``d = 1``),
    on the device they came on (numpy input lands on the CPU)."""
    X = torch.as_tensor(X)
    if X.ndim == 1:
        X = X[:, None]
    return X.to(mode_dtype(mode)).contiguous()


def _as_rhs(v, X1, mode):
    """``((hi, lo), vector)``: ``v`` as ``(n1, r)`` in the points' dtype
    and device; ``lo`` is the lo plane of an ff pair (mode ff only), or
    ``None``."""
    if isinstance(v, tuple):
        if mode != "ff":
            raise ValueError(f"an ff pair right-hand side needs mode 'ff', got {mode!r}")
        hi, lo = (torch.as_tensor(c).to(device=X1.device, dtype=X1.dtype) for c in v)
    else:
        hi, lo = torch.as_tensor(v).to(device=X1.device, dtype=X1.dtype), None
    vector = hi.ndim == 1
    if vector:
        hi = hi[:, None]
        lo = None if lo is None else lo[:, None]
    if hi.shape[0] != X1.shape[0]:
        raise ValueError(f"v has {hi.shape[0]} rows, X1 has {X1.shape[0]} points")
    return (hi.contiguous(), None if lo is None else lo.contiguous()), vector


def _check_same_device(*ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")


def gram(terms, X0, X1, mode=None) -> torch.Tensor:
    """The ``(n0, n1)`` Gram of a sum-of-products kernel (no outer scale,
    like ``pallas_gram``).  ``X0``/``X1``: ``(n, d)`` points; the result
    has the mode's dtype and the points' device.  CUDA tensors launch
    K1; CPU tensors take :func:`gram_plain`."""
    mode = resolve_mode(mode)
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    _check_same_device(X0, X1)
    if X0.is_cuda:
        from . import _cuda

        return _cuda.gram(_collapse_terms(tuple(terms)), X0, X1, mode)
    if X0.device.type != "cpu":
        raise ValueError(f"no route for device {X0.device}")
    return gram_plain(terms, X0, X1, mode)


def gram_matvec(spec, X0, X1, v, mode=None) -> torch.Tensor:
    """``scale * K(X0, X1) @ v`` without materializing ``K``, for a
    ``(scale, terms)`` spec.  ``v``: ``(n1,)`` or ``(n1, r)``, or in mode
    ff also an ff pair ``(hi, lo)`` of those.  CUDA tensors launch K2;
    CPU tensors take :func:`gram_matvec_plain`."""
    mode = resolve_mode(mode)
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    _check_same_device(X0, X1)
    if X0.is_cuda:
        from . import _cuda

        scale, terms = spec
        (v, v_lo), vector = _as_rhs(v, X1, mode)
        out = _cuda.gram_matvec(_collapse_terms(tuple(terms)), X0, X1, v, mode, v_lo)
        if scale != 1.0:
            out = scale * out
        return out[:, 0] if vector else out
    if X0.device.type != "cpu":
        raise ValueError(f"no route for device {X0.device}")
    return gram_matvec_plain(spec, X0, X1, v, mode)
