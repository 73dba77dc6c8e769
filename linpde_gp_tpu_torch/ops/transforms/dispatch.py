"""The rule engine: apply linear operators to functions, covariance
functions and processes.

Port of ``linpde_gp_tpu/ops/transforms/dispatch.py``:

1. Operators are normalized to coefficient tables (:func:`as_coefficients`).
2. Transformed kernels carry their provenance ``(base, coeffs0, coeffs1)``,
   so a second operator composes symbolically (:func:`compose_coefficients`).
3. The closed form is built when the base kernel is a product
   (``product.py``), else for an isotropic multivariate half-integer Matérn
   (``radial.py``); any other kernel takes the autodiff fallback
   (``autodiff.py``), never an error.  Multi-output kernels take the
   ``SelectOutput`` and stacked-slot rewrites.

Functions: coefficient diffops through ``apply_diffop_to_function`` (its
exact shortcuts, else autodiff), output selection, and scaled, summed and
composite operators.  Operators also act on processes and
cross-covariances (:func:`apply_operator`).
"""

from __future__ import annotations

import numpy as np

from ...models.functions.base import Function, LambdaFunction, Zero
from ...models.functions.basic import StackedFunction
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
from ..kernels.multioutput import IndependentMultiOutputCovarianceFunction, StackCovarianceFunction
from .autodiff import AutodiffTransformedKernel, apply_diffop_to_function
from .product import SumOfProductsKernel, transform_product_kernel
from .radial import RadialMaternDerivativeKernel, transform_radial_kernel


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
    """``op(f)`` symbolically (``dispatch.py:136-168`` of the JAX package):
    output selection, coefficient diffops through
    :func:`~.autodiff.apply_diffop_to_function`, and scaled, summed and
    composite operators.  A zero function stays zero, with the operator's
    output shapes."""
    if isinstance(op, Identity):
        return f
    if isinstance(f, Zero):
        return Zero(op.output_domain_shape, op.output_codomain_shape)
    if isinstance(op, SelectOutput):
        if isinstance(f, StackedFunction) and len(op.idx) == 1:
            return f.fns[op.idx[0]]
        return LambdaFunction(lambda x, f=f, idx=op.idx: f(x)[(Ellipsis,) + idx], op.input_domain_shape, ())
    coeffs = as_coefficients(op)
    if coeffs is not None:
        return apply_diffop_to_function(coeffs, f)
    if isinstance(op, ScaledLinearFunctionOperator):
        return op.scalar * apply_operator_to_function(op.linfuncop, f)
    if isinstance(op, SumLinearFunctionOperator):
        out = None
        for s in op.summands:
            term = apply_operator_to_function(s, f)
            out = term if out is None else out + term
        return out
    if isinstance(op, CompositeLinearFunctionOperator):
        for sub in reversed(op.linfuncops):
            f = apply_operator_to_function(sub, f)
        return f
    raise NotImplementedError(f"Cannot apply operator {type(op).__name__} to a function.")


def apply_operator_to_kernel(
    op: LinearFunctionOperator, kernel: CovarianceFunction, *, argnum: int
) -> CovarianceFunction:
    """Apply a linear operator to one argument of a covariance function:
    ``L k`` for ``argnum=0``, ``k L*`` for ``argnum=1``.  Closed forms for
    the product and radial families, the autodiff fallback otherwise.

    >>> import torch
    >>> from linpde_gp_tpu_torch.ops import diffops
    >>> from linpde_gp_tpu_torch.ops.kernels import Matern, TensorProduct
    >>> kt = TensorProduct(Matern((), nu=1.5), Matern((), nu=2.5))
    >>> H = diffops.HeatOperator((2,), alpha=1.0)  # d/dt - alpha * Laplace
    >>> k_h = apply_operator_to_kernel(H, kt, argnum=1)
    >>> round(float(k_h(torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64))), 6)
    -0.429992
    """
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
    if isinstance(kernel, StackCovarianceFunction):
        if argnum != kernel.stack_argnum:
            # The operator acts on the scalar slot: distribute over the entries.
            return StackCovarianceFunction(
                *(apply_operator_to_kernel(op, k, argnum=argnum) for k in kernel.covfuncs),
                stack_argnum=kernel.stack_argnum,
            )
        if isinstance(op, SelectOutput) and len(op.idx) == 1:
            return kernel.covfuncs[op.idx[0]]
        # Unfold structured operators until a SelectOutput reaches the stacked slot.
        structured = _decompose_structured_op(op, kernel, argnum)
        if structured is not None:
            return structured
        raise NotImplementedError("Only SelectOutput can act on the stacked slot of a StackCovarianceFunction.")
    if isinstance(op, SelectOutput):
        return _select_output_kernel(op, kernel, argnum)

    # -- operator structure ---------------------------------------------------
    coeffs = as_coefficients(op)
    if coeffs is None:
        structured = _decompose_structured_op(op, kernel, argnum)
        if structured is not None:
            return structured
        raise NotImplementedError(f"Cannot apply {type(op).__name__} to a kernel.")

    # -- diffop path: compose with provenance --------------------------------------
    if isinstance(kernel, (SumOfProductsKernel, AutodiffTransformedKernel, RadialMaternDerivativeKernel)) and (
        kernel.base is not None
    ):
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
    radial = transform_radial_kernel(base, c0, c1)
    if radial is not None:
        return radial
    return AutodiffTransformedKernel(base, c0, c1)


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


def _select_output_kernel(op: SelectOutput, kernel: CovarianceFunction, argnum: int):
    """Output selection on one slot of a multi-output kernel
    (``dispatch.py:312-331`` of the JAX package)."""
    idx = op.idx
    if isinstance(kernel, IndependentMultiOutputCovarianceFunction) and len(idx) == 1:
        other_shape = kernel.output_shape_0 if argnum == 1 else kernel.output_shape_1
        if other_shape == ():
            return kernel.covfuncs[idx[0]]
        # Diagonal structure: selecting component i on one slot leaves a
        # stacked kernel whose only nonzero entry is k_i at position i, so
        # further operators reach the component's closed forms.
        entries = [
            kernel.covfuncs[idx[0]] if j == idx[0] else ZeroCovarianceFunction(kernel.input_shape)
            for j in range(len(kernel.covfuncs))
        ]
        return StackCovarianceFunction(*entries, stack_argnum=1 - argnum)
    return _SelectedOutputKernel(kernel, idx, argnum)


class _SelectedOutputKernel(CovarianceFunction):
    """Output-component selection on one slot of any kernel."""

    def __init__(self, kernel: CovarianceFunction, idx, argnum: int):
        self._kernel = kernel
        self._idx = tuple(idx)
        self._argnum = argnum
        out0 = () if argnum == 0 else kernel.output_shape_0
        out1 = () if argnum == 1 else kernel.output_shape_1
        super().__init__(kernel.input_shape, out0, out1)

    def _evaluate(self, x0, x1):
        vals = self._kernel._evaluate(x0, x1)
        if self._argnum == 0:  # the output_shape_0 axes, just before output_shape_1's
            return vals[(Ellipsis,) + self._idx + (slice(None),) * self._kernel.output_ndim_1]
        return vals[(Ellipsis,) + self._idx]  # the trailing output_shape_1 axes
