"""The frozen yardstick of the roofline readings: peaks, and the operations
and bytes that the mathematics of a call needs.

A count here depends on the kernel form (from the configuration file), the
pairs, the right-hand-side columns ``r`` and the precision, and never on the
route or the kernel that the program takes:

- a kernel value is evaluated once per pair that the mathematics needs: a
  symmetric Gram (a form of ``X`` with itself) needs ``n (n + 1) / 2``;
- the product with ``r`` columns is ``r`` multiply-adds for every entry of
  the matrix;
- each operation is charged to the fastest pipe that can do it in the
  precision: in float64 the evaluation to the FP64 FMA units, the
  multiply-adds of the product to the FP64 tensor cores; in float32 the
  evaluation and the product to the FP32 FMA units and the exponential to
  the special-function units (MUFU ``ex2``);
- each input is read once and each output written once.

The least time of a call is the larger of its busiest pipe's and its bytes'
(``bound_s``).  Replaces ``chip_smoke.kernel_bound`` / ``matvec_bytes`` and
``ops/_cuda.pair_ops`` of the program, whose count follows the program's
structure and routes.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, at 700 W), as instruction rates: an
#: FMA is one instruction of two flops.  FP64 34 TFLOP/s outside the tensor
#: cores (33.5 used, as the data sheet's 67 / 2), FP64 tensor cores 67
#: TFLOP/s, FP32 67 TFLOP/s; MUFU 16 per SM and clock, 132 SMs at the 1.98
#: GHz boost clock; HBM3 3.35 TB/s.
PEAK = {
    "fp64": 33.5e12 / 2,
    "fp64_tc": 67e12 / 2,
    "fp32": 67e12 / 2,
    "mufu": 16 * 132 * 1.98e9,
    "bytes": 3.35e12,
}
#: The FP64 tensor cores in flops a second, the peak of a dense factorization.
FP64_TC_FLOPS = 67e12

#: Instructions of one exponential: float64 has no special-function unit, so
#: two FMAs of range reduction and a degree-11 polynomial (11 FMAs) on the
#: FP64 pipe; float32 one multiply by log2(e) on the FP32 pipe and one MUFU ex2.
EXP_OPS = {"f64": {"fp64": 13}, "f32": {"fp32": 1, "mufu": 1}}
#: Bytes of one value.
SIZE = {"f64": 8, "f32": 4}
EVAL_PIPE = {"f64": "fp64", "f32": "fp32"}
PRODUCT_PIPE = {"f64": "fp64_tc", "f32": "fp32"}


def precision(mode: str) -> str:
    """The precision of the program's mode: ``f64`` or ``f32`` (``plain``)."""
    if mode == "f64":
        return "f64"
    if mode == "plain":
        return "f32"
    raise ValueError(f"no frozen count for mode {mode!r}")


def eval_ops(form: dict, prec: str) -> dict:
    """Instructions per pair to evaluate a kernel form, by pipe.

    ``form``: ``{"nd": d, "envelopes": e, "terms": [[deg_0, ..., deg_d-1],
    ...]}``, a sum of terms, each a product over the dimensions of a
    polynomial of the scaled distance ``s_i = c_i |x_i - x'_i|`` of the given
    degree, times the envelope ``exp(-sum_i s_i)`` (one for all terms when
    ``e = 1``).  Per pair: ``d`` differences and ``d`` scalings; per envelope
    ``d - 1`` adds, an exponential and one multiply; per term one FMA per
    degree (Horner) and ``d - 1`` multiplies; ``terms - 1`` adds.  Constant
    factors fold into the coefficients; signs and absolute values are free.
    """
    nd, terms, env = form["nd"], form["terms"], form["envelopes"]
    n = 2 * nd + env * ((nd - 1) + 1)
    n += sum(sum(t) + (nd - 1) for t in terms) + (len(terms) - 1)
    ops = {EVAL_PIPE[prec]: n}
    for pipe, k in EXP_OPS[prec].items():
        ops[pipe] = ops.get(pipe, 0) + env * k
    return ops


def bound_s(ops: dict, nbytes: float) -> float:
    """Least seconds for ``ops`` (instructions by pipe) and ``nbytes``."""
    return max([c / PEAK[p] for p, c in ops.items()] + [nbytes / PEAK["bytes"]])


def _add(a: dict, b: dict, scale: float = 1.0) -> dict:
    out = dict(a)
    for p, c in b.items():
        out[p] = out.get(p, 0) + scale * c
    return out


def gram_work(form: dict, prec: str, n0: int, n1: int, *, symmetric: bool = False, nd: int = 2):
    """``(ops, bytes)`` of forming a Gram ``K(X0, X1)`` (K1): each needed
    pair evaluated and stored once, the points read once."""
    pairs = n0 * (n0 + 1) // 2 if symmetric else n0 * n1
    ops = {p: c * pairs for p, c in eval_ops(form, prec).items()}
    pts = n0 if symmetric else n0 + n1
    return ops, SIZE[prec] * (pairs + pts * nd)


def matvec_work(form: dict, prec: str, n0: int, n1: int, r: int, *, symmetric: bool = False, nd: int = 2):
    """``(ops, bytes)`` of ``K(X0, X1) @ V`` with ``V`` of ``r`` columns
    without forming ``K`` (K2): each needed pair evaluated once, ``n0 n1 r``
    multiply-adds, the points and ``V`` read once, the result written once."""
    pairs = n0 * (n0 + 1) // 2 if symmetric else n0 * n1
    ops = {p: c * pairs for p, c in eval_ops(form, prec).items()}
    ops = _add(ops, {PRODUCT_PIPE[prec]: n0 * n1 * r})
    pts = n0 if symmetric else n0 + n1
    return ops, SIZE[prec] * (pts * nd + n1 * r + n0 * r)


def calls_bound_s(works) -> float:
    """Least seconds of a sequence of calls: the sum of each call's bound."""
    return sum(bound_s(ops, nbytes) for ops, nbytes in works)


def cholesky_work(m: int):
    """``(flops, bytes)`` of a float64 Cholesky of ``m x m``: ``m^3 / 3``
    flops, the lower triangle read and written once."""
    return m**3 / 3, 8 * m * (m + 1)


def extend_work(n: int, m: int):
    """``(flops, bytes)`` of extending a factor of ``n`` by ``m`` rows:
    ``C = L^{-1} B`` (``n^2 m``), ``D - C^T C`` (``n m^2``, symmetric), and
    the Cholesky of the ``m x m`` Schur complement."""
    f, b = cholesky_work(m)
    return f + n * n * m + n * m * m, b + 8 * (n * (n + 1) // 2 + 2 * n * m + m * m)


def solve_work(m: int):
    """``(flops, bytes)`` of the two triangular solves of one right-hand side
    with a factor of ``m``: ``2 m^2`` flops, the triangle read twice."""
    return 2.0 * m * m, 8 * m * (m + 1)


def dense_bound_s(works) -> float:
    """Least seconds of dense linear algebra ``(flops, bytes)`` calls at the
    FP64 tensor cores' peak and the memory's."""
    return sum(max(f / FP64_TC_FLOPS, b / PEAK["bytes"]) for f, b in works)


def anchored_conditioning_work(n: int, cuts: list[int]):
    """The dense linear algebra of conditioning on anchor sets of the sizes
    ``cuts`` one at a time and then on ``n`` PDE points: the first set's
    Cholesky, one extension per later set, and the weights after each call."""
    works, have = [], 0
    for m in list(cuts) + [n]:
        works.append(cholesky_work(m) if have == 0 else extend_work(have, m))
        have += m
        works.append(solve_work(have))
    return works
