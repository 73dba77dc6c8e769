"""The rule engine: apply linear operators to covariance functions.

Port of ``linpde_gp_tpu/ops/transforms/dispatch.py`` on the closed-form
product route only:

1. Operators are normalized to coefficient tables (:func:`as_coefficients`).
2. Transformed kernels carry their provenance ``(base, coeffs0, coeffs1)``,
   so a second operator composes symbolically (:func:`compose_coefficients`).
3. The closed form is built when the base kernel is a product
   (``product.py``).

Where the JAX package falls back to radial closed forms or to autodiff
(``dispatch.py:274-284`` there), this port raises ``NotImplementedError``:
those routes come with ROADMAP Queue 1 item 9d.  It never returns a
different kernel in their place.  Operators act on processes and on zero
functions here too; other functions wait for item 9b.
"""

from __future__ import annotations

import numpy as np

from ...models.functions.base import Function, Zero
from ..diffops.coefficients import MultiIndex, PartialDerivativeCoefficients
from ..diffops.lindiffop import LinearDifferentialOperator
from ..diffops.linfuncop import (
    CompositeLinearFunctionOperator,
    Identity,
    LinearFunctionOperator,
    ScaledLinearFunctionOperator,
    SelectOutput,
    SumLinearFunctionOperator,
)
from ..kernels.arithmetic import ScaledCovarianceFunction, SumCovarianceFunction, ZeroCovarianceFunction
from ..kernels.base import CovarianceFunction
from .product import SumOfProductsKernel, transform_product_kernel

_NOT_PORTED = "(radial closed forms and the autodiff fallback are ROADMAP Queue 1 item 9d)"


def as_coefficients(op: LinearFunctionOperator) -> PartialDerivativeCoefficients | None:
    """Normalize an operator into a single coefficient table, if possible."""
    if isinstance(op, LinearDifferentialOperator):
        return op.coefficients
    if isinstance(op, Identity):
        if op.input_codomain_shape != ():
            return None
        return PartialDerivativeCoefficients(
            {(): {MultiIndex(np.zeros(op.input_domain_shape, dtype=int)): 1.0}}, op.input_domain_shape, ()
        )
    if isinstance(op, ScaledLinearFunctionOperator):
        inner = as_coefficients(op.linfuncop)
        return None if inner is None else op.scalar * inner
    if isinstance(op, SumLinearFunctionOperator):
        total = None
        for s in op.summands:
            coeffs = as_coefficients(s)
            if coeffs is None:
                return None
            total = coeffs if total is None else total + coeffs
        return total
    if isinstance(op, CompositeLinearFunctionOperator):
        total = None
        for sub in reversed(op.linfuncops):  # innermost first
            coeffs = as_coefficients(sub)
            if coeffs is None:
                return None
            total = coeffs if total is None else compose_coefficients(coeffs, total)
        return total
    return None


def compose_coefficients(
    outer: PartialDerivativeCoefficients, inner: PartialDerivativeCoefficients
) -> PartialDerivativeCoefficients:
    """``outer o inner`` for constant-coefficient scalar-codomain diffops:
    ``d^a o d^b = d^{a+b}``."""
    if list(outer.keys()) != [()] or list(inner.keys()) != [()]:
        raise NotImplementedError("Composition of multi-output diffops is not supported.")
    new: dict = {(): {}}
    for _, mi_o, c_o in outer.items_flat():
        for _, mi_i, c_i in inner.items_flat():
            mi = MultiIndex(mi_o.array + mi_i.array)
            new[()][mi] = new[()].get(mi, 0.0) + c_o * c_i
    return PartialDerivativeCoefficients(new, inner.input_domain_shape, inner.input_codomain_shape)


def apply_operator(op: LinearFunctionOperator, obj, /, **kwargs):
    """``op(obj)``: for a covariance function ``L k L*`` by default, one slot
    with ``argnum=``; for a (posterior) GP the pushforward process
    (``dispatch.py:120-130`` of the JAX package); for a cross-covariance its
    process slot; for a function :func:`apply_operator_to_function`."""
    from ...models.gp import ConditionalGaussianProcess, GaussianProcess
    from ...models.randprocs import DeterministicProcess
    from ..crosscov.base import ProcessVectorCrossCovariance

    if isinstance(obj, CovarianceFunction):
        argnum = kwargs.get("argnum", None)
        if argnum is None:
            return apply_operator_to_kernel(op, apply_operator_to_kernel(op, obj, argnum=1), argnum=0)
        return apply_operator_to_kernel(op, obj, argnum=argnum)
    if isinstance(obj, ConditionalGaussianProcess):
        return obj._apply_operator(op)
    if isinstance(obj, GaussianProcess):
        return GaussianProcess(apply_operator(op, obj.mean), apply_operator(op, obj.cov), device=obj.device)
    if isinstance(obj, DeterministicProcess):
        return DeterministicProcess(apply_operator(op, obj.as_fn()))
    if isinstance(obj, ProcessVectorCrossCovariance):
        return obj.apply_operator(op)
    if isinstance(obj, Function):
        return apply_operator_to_function(op, obj)
    raise TypeError(f"Cannot apply {op!r} to object of type {type(obj).__name__}.")


def apply_operator_to_function(op: LinearFunctionOperator, f: Function) -> Function:
    """``op(f)`` symbolically: the identity keeps ``f``, and a zero function
    stays zero with the operator's output shapes.  Other functions wait for
    ROADMAP Queue 1 item 9b."""
    if isinstance(op, Identity):
        return f
    if isinstance(f, Zero):
        return Zero(op.output_domain_shape, op.output_codomain_shape)
    raise NotImplementedError(
        f"Applying an operator to {type(f).__name__} is not ported yet (functions: ROADMAP Queue 1 item 9b)."
    )


def apply_operator_to_kernel(
    op: LinearFunctionOperator, kernel: CovarianceFunction, *, argnum: int
) -> CovarianceFunction:
    """Apply a linear operator to one argument of a covariance function:
    ``L k`` for ``argnum=0``, ``k L*`` for ``argnum=1``."""
    if argnum not in (0, 1):
        raise ValueError(f"argnum must be 0 or 1, got {argnum!r}")
    if isinstance(op, Identity):
        return kernel

    # -- kernel structure ---------------------------------------------------
    if isinstance(kernel, ScaledCovarianceFunction):
        return ScaledCovarianceFunction(apply_operator_to_kernel(op, kernel.covfunc, argnum=argnum), kernel.scalar)
    if isinstance(kernel, SumCovarianceFunction):
        return SumCovarianceFunction(*(apply_operator_to_kernel(op, s, argnum=argnum) for s in kernel.summands))
    if isinstance(kernel, ZeroCovarianceFunction):
        out0 = kernel.output_shape_0 if argnum == 1 else op.output_codomain_shape
        out1 = kernel.output_shape_1 if argnum == 0 else op.output_codomain_shape
        return ZeroCovarianceFunction(op.output_domain_shape, out0, out1)
    if isinstance(op, SelectOutput):
        raise NotImplementedError("multi-output kernels are not ported yet (ROADMAP Queue 1 item 9d)")

    # -- operator structure ---------------------------------------------------
    coeffs = as_coefficients(op)
    if coeffs is None:
        structured = _decompose_structured_op(op, kernel, argnum)
        if structured is not None:
            return structured
        raise NotImplementedError(f"Cannot apply {type(op).__name__} to a kernel.")

    # -- diffop path: compose with provenance --------------------------------------
    if isinstance(kernel, SumOfProductsKernel) and kernel.base is not None:
        base = kernel.base
        c0, c1 = kernel.coeffs0, kernel.coeffs1
        if argnum == 0:
            c0 = coeffs if c0 is None else compose_coefficients(coeffs, c0)
        else:
            c1 = coeffs if c1 is None else compose_coefficients(coeffs, c1)
    else:
        base = kernel
        c0 = coeffs if argnum == 0 else None
        c1 = coeffs if argnum == 1 else None

    closed = transform_product_kernel(base, c0, c1)
    if closed is not None:
        return closed
    raise NotImplementedError(
        f"No closed form for {op!r} on {type(base).__name__} {_NOT_PORTED}: the kernel is not a "
        "product of ExpQuad/half-integer Matern/Wendland factors, or the derivative order exceeds "
        "its smoothness."
    )


def _decompose_structured_op(op: LinearFunctionOperator, kernel: CovarianceFunction, argnum: int):
    """Unfold scaled, summed and composite operators; ``None`` if ``op``
    is elementary."""
    if isinstance(op, ScaledLinearFunctionOperator):
        return ScaledCovarianceFunction(apply_operator_to_kernel(op.linfuncop, kernel, argnum=argnum), op.scalar)
    if isinstance(op, SumLinearFunctionOperator):
        return SumCovarianceFunction(*(apply_operator_to_kernel(s, kernel, argnum=argnum) for s in op.summands))
    if isinstance(op, CompositeLinearFunctionOperator):
        out = kernel
        for sub in reversed(op.linfuncops):
            out = apply_operator_to_kernel(sub, out, argnum=argnum)
        return out
    return None
