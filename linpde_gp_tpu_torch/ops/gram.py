"""Gram assembly (K1) and gram-free Gram matvec (K2) of sum-of-products
kernels.

Port of the main-path part of ``linpde_gp_tpu/ops/pallas_gram.py``.  A
spec's terms collapse into a few multivariate polynomial groups
(:func:`_collapse_terms`, copied from the JAX package); each pair of
points then costs one ``exp`` per distinct ``(dim, kind, scale)`` and a
nested Horner sweep per group.

Routing: a CUDA tensor goes to the hand-written kernels of
``csrc/gram.cuh``, compiled per spec structure (through ``ops/_cuda.py``);
a CPU tensor goes to the plain PyTorch version in this module
(:func:`gram_plain`, :func:`gram_matvec_plain`), except in mode f64 from
``config.native_gram_threshold`` pairs, where it goes to the g++ host
engine (``native/``; ``pallas_gram.py:520-531``, ``:555-590`` of the JAX
package) if a toolchain is present.  Modes plain and ff keep their plain
versions on the CPU: there they stand for the card's arithmetic, and the
engine is float64.  There is no other route and no fallback.
:func:`gram_matrix` takes a kernel object and routes through :func:`gram`.  K2 takes one of two routes by the number r of
right-hand-side columns (``csrc/gram.cuh``): a few output rows per thread
for r <= 4, and for r > 4 a route that evaluates each pair once per block
of 64 to 256 columns.  :func:`gram_matvec_sym` is K2 on a Gram of a point
set with itself, which the caller states by calling it: for r <= 4 it
evaluates each unordered pair once.

Modes (``config.py``): ``"plain"`` (float32), ``"ff"`` (float32
float-float pairs, the JAX package's ``compensated=True``) and ``"f64"``
(float64).  The ff Gram stores ``hi + lo``.  The ff matvec takes ``v`` as
a tensor or as an ff pair ``(hi, lo)``, carries every product and the sum
past float32, and returns the ff pair ``(hi, lo)`` of the result (``hi``
is its float32 rounding), on both routes and in the plain version.  It
departs from the TPU kernel here, which summed ``hi * v`` and ``lo * v``
in f32. At N = 1e5 and
noise 1e-3 these sums cancel by ~5e7, and the f32 sum left CG unable to
converge; rounding the result to f32 left the ff variance erring at first
order in the CG residual (PERF.md, ROADMAP Queue 3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import config, mode_dtype, resolve_device, resolve_mode
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


def kernel_term_specs(kernel) -> tuple[float, tuple] | None:
    """``(outer_scale, terms)`` of a kernel of the sum-of-products
    closed-form family, or ``None`` (``pallas_gram.py:460`` of the JAX
    package; tuple for tuple the same spec)."""
    from .kernels.arithmetic import ScaledCovarianceFunction
    from .transforms.product import SumOfProductsKernel, transform_product_kernel

    scale = 1.0
    while isinstance(kernel, ScaledCovarianceFunction):
        scale *= kernel.scalar
        kernel = kernel.covfunc
    # A base kernel is the identity transform of itself.
    sop = kernel if isinstance(kernel, SumOfProductsKernel) else transform_product_kernel(kernel, None, None)
    if sop is None:
        return None
    terms = tuple(
        (float(c), tuple((f.kind, f.scale, f.poly, f.parity, f.prefactor) for f in factors))
        for c, factors in sop.terms
    )
    return scale, terms


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


def _check_dims(terms, X0, X1) -> None:
    """The points' width must be the spec's number of dimensions (as the
    kernels' ``_cuda._dims`` checks it)."""
    nd = len(terms[0][1])
    if X0.shape[1] != nd or X1.shape[1] != nd:
        raise ValueError(f"points have {X0.shape[1]}/{X1.shape[1]} dims, the spec {nd}")


def _check_input_shape(kernel, X) -> None:
    """``X`` must end in ``kernel.input_shape`` (the JAX package's
    ``gram_matrix`` fails to reshape other points)."""
    shape, have = tuple(kernel.input_shape), tuple(X.shape if hasattr(X, "shape") else np.shape(X))
    if shape and have[len(have) - len(shape):] != shape:
        raise ValueError(f"points of shape {have} for a kernel of input shape {shape}")


def gram_plain(terms, X0, X1, mode=None) -> torch.Tensor:
    """Plain PyTorch version of K1 on any device, in row blocks."""
    mode = resolve_mode(mode)
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    _check_dims(terms, X0, X1)
    groups = _collapse_terms(tuple(terms))
    n0, n1 = X0.shape[0], X1.shape[0]
    out = torch.empty((n0, n1), dtype=X0.dtype, device=X0.device)
    starts, step = _row_blocks(n0, n1, X0.device)
    for s in starts:
        blk = _eval_block(groups, X0[s:s + step], X1, mode)
        out[s:s + step] = blk[0] + blk[1] if mode == "ff" else blk
    return out


def gram_matvec_plain(spec, X0, X1, v, mode=None):
    """Plain PyTorch version of K2 (``scale * K(X0, X1) @ v``) on any
    device, in row blocks.  Mode ff takes ``v`` or an ff pair, forms the
    product of the ff entries with it and the sum in float64 (the kernel
    carries them in ff) and returns the ff pair ``(hi, lo)`` of the
    result; the other modes return one tensor."""
    mode = resolve_mode(mode)
    scale, terms = spec
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    _check_dims(terms, X0, X1)
    (v, v_lo), vector = _as_rhs(v, X1, mode)
    if mode == "ff":
        v = v.double() if v_lo is None else v.double() + v_lo.double()
    groups = _collapse_terms(tuple(terms))
    n0, n1 = X0.shape[0], X1.shape[0]
    out = torch.empty((n0, v.shape[1]), dtype=v.dtype, device=X0.device)
    starts, step = _row_blocks(n0, n1, X0.device)
    for s in starts:
        blk = _eval_block(groups, X0[s:s + step], X1, mode)
        out[s:s + step] = (blk[0].double() + blk[1].double()) @ v if mode == "ff" else blk @ v
    if scale != 1.0:
        out = scale * out
    if vector:
        out = out[:, 0]
    return ff.ff_split(out) if mode == "ff" else out


# -- public entry points ---------------------------------------------------------


def _as_points(X, mode) -> torch.Tensor:
    """``(n, d)`` points in the mode's dtype (``(n,)`` means ``d = 1``): a
    tensor on its device, numpy input on the default device
    (``config.resolve_device``: the card unless the CPU is asked for)."""
    X = X if isinstance(X, torch.Tensor) else torch.tensor(np.asarray(X), device=resolve_device())
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


def _native(spec, mode, n0: int, n1: int):
    """The host engine for a CPU call (``pallas_gram.py:520-531`` of the JAX
    package), or ``None``: mode f64, ``config.use_native_host_engine``,
    ``n0 * n1 >= config.native_gram_threshold`` and a toolchain present."""
    if mode != "f64" or not config.use_native_host_engine or n0 * n1 < config.native_gram_threshold:
        return None
    from .. import native

    return native.engine_for_spec(*spec)


def _check_same_device(*ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")


def gram(terms, X0, X1, mode=None) -> torch.Tensor:
    """The ``(n0, n1)`` Gram of a sum-of-products kernel (no outer scale,
    like ``pallas_gram``).  ``X0``/``X1``: ``(n, d)`` points; the result
    has the mode's dtype and the points' device.  CUDA tensors launch
    K1; CPU tensors take the host engine (mode f64, large calls: see
    :func:`_native`) or :func:`gram_plain`."""
    mode = resolve_mode(mode)
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    _check_same_device(X0, X1)
    _check_dims(terms, X0, X1)
    if X0.is_cuda:
        from . import _cuda

        return _cuda.gram(_collapse_terms(tuple(terms)), X0, X1, mode)
    if X0.device.type != "cpu":
        raise ValueError(f"no route for device {X0.device}")
    eng = _native((1.0, tuple(terms)), mode, X0.shape[0], X1.shape[0])
    if eng is not None:
        return eng.gram(X0, X1)
    return gram_plain(terms, X0, X1, mode)


def gram_matrix(kernel, X0, X1=None, mode=None) -> torch.Tensor:
    """Dense Gram ``k(X0, X1)`` of a scalar kernel (``pallas_gram.py:499`` of
    the JAX package).  A kernel of the sum-of-products family takes ``scale *
    gram(terms, ...)`` of ``kernel_term_specs(kernel)``: K1 on CUDA tensors,
    :func:`gram_plain` on CPU tensors.  Any other kernel (radial, autodiff,
    general-``nu`` Matérn) is evaluated by its own ``_evaluate`` on the
    broadcast points, in torch on the points' device (the JAX package forms
    it outside any Pallas kernel too), in float64 on the points rounded to
    the mode's dtype, and returned in that dtype.  ``X0`` / ``X1``: ``(n,) +
    input_shape`` points (``X1=None``: ``X0``); other trailing shapes
    raise ``ValueError``."""
    _check_input_shape(kernel, X0)
    if X1 is not None:
        _check_input_shape(kernel, X1)
    X0 = _as_points(X0, mode)
    X1 = X0 if X1 is None else _as_points(X1, mode)
    d = max(kernel.input_size, 1)
    spec = kernel_term_specs(kernel)
    if spec is None:
        shape = (-1,) + tuple(kernel.input_shape)
        out = kernel.matrix(X0.double().reshape(shape), X1.double().reshape(shape))
        return out.to(mode_dtype(mode))
    scale, terms = spec
    out = gram(terms, X0.reshape(-1, d), X1.reshape(-1, d), mode)
    return scale * out if scale != 1.0 else out


def gram_matvec(spec, X0, X1, v, mode=None):
    """``scale * K(X0, X1) @ v`` without materializing ``K``, for a
    ``(scale, terms)`` spec.  ``v``: ``(n1,)`` or ``(n1, r)``, or in mode
    ff also an ff pair ``(hi, lo)`` of those.  Mode ff returns the ff pair
    ``(hi, lo)`` of the result (``hi``: its float32 rounding).  CUDA
    tensors launch K2; CPU tensors take the host engine (mode f64, large
    calls: see :func:`_native`) or :func:`gram_matvec_plain`."""
    mode = resolve_mode(mode)
    X0, X1 = _as_points(X0, mode), _as_points(X1, mode)
    _check_same_device(X0, X1)
    _check_dims(spec[1], X0, X1)
    if X0.is_cuda:
        from . import _cuda

        scale, terms = spec
        (v, v_lo), vector = _as_rhs(v, X1, mode)
        out = _cuda.gram_matvec(_collapse_terms(tuple(terms)), X0, X1, v, mode, v_lo, scale=scale)
        if vector:
            out = (out[0][:, 0], out[1][:, 0]) if mode == "ff" else out[:, 0]
    elif X0.device.type == "cpu":
        eng = _native(spec, mode, X0.shape[0], X1.shape[0])
        if eng is not None:
            (v, _), vector = _as_rhs(v, X1, mode)
            out = eng.matvec(X0, X1, v)
            out = out[:, 0] if vector else out
        else:
            out = gram_matvec_plain(spec, X0, X1, v, mode)
    else:
        raise ValueError(f"no route for device {X0.device}")
    return out


def gram_matvec_sym(spec, X, v, mode=None):
    """``scale * K(X, X) @ v`` for a ``(scale, terms)`` spec whose kernel is
    symmetric, ``k(x, y) = k(y, x)`` (an observation kernel ``L k L*``);
    ``v`` and the result as :func:`gram_matvec`.  CUDA tensors launch K2's
    symmetric route for r <= 4, which evaluates each unordered pair once,
    and its multi-column route above; the symmetric route keeps a scratch
    of n^2 / (2 B) values a stream (``_cuda.release_sym_scratch``).  CPU
    tensors take :func:`gram_matvec`'s route on ``(X, X)``."""
    mode = resolve_mode(mode)
    X = _as_points(X, mode)
    if not X.is_cuda:
        return gram_matvec(spec, X, X, v, mode)
    from . import _cuda

    _check_dims(spec[1], X, X)
    scale, terms = spec
    (v, v_lo), vector = _as_rhs(v, X, mode)
    out = _cuda.gram_matvec_sym(_collapse_terms(tuple(terms)), X, v, mode, v_lo, scale=scale)
    if vector:
        out = (out[0][:, 0], out[1][:, 0]) if mode == "ff" else out[:, 0]
    return out
