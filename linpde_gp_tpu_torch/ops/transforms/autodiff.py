"""Forward-mode autodiff fallback for differential operators.

Port of ``linpde_gp_tpu/ops/transforms/autodiff.py`` on
``torch.func.jvp``: any coefficient diffop applies to any function and to
any kernel with no closed form (the reference's jvp/hessian fallback).

The batched-jvp trick: for a pointwise-batched ``f(x)`` (each output
depends only on its own input point), ``torch.func.jvp`` along a tangent
that broadcasts one constant direction over the batch gives the
directional derivative at every batch point in one pass; nesting it gives
the higher partial derivatives.  Everything runs on the input's device and
in its dtype (float64 for the symbolic layer's callers).
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.functions.base import Function, Zero
from ...models.functions.basic import Constant, Piecewise
from ...models.functions.polynomial import Polynomial
from ..diffops.coefficients import PartialDerivativeCoefficients
from ..kernels.base import CovarianceFunction


def _unit_direction(input_shape, index, x: torch.Tensor) -> torch.Tensor:
    """The unit vector along ``index`` of ``input_shape``, in ``x``'s dtype
    and on its device."""
    if input_shape == ():
        return torch.ones((), dtype=x.dtype, device=x.device)
    e = np.zeros(input_shape)
    e[index] = 1.0
    return torch.as_tensor(e, dtype=x.dtype, device=x.device)


def nested_derivative(fn, multi_index, input_shape):
    """``x -> d^alpha fn(x)`` for a batched pointwise ``fn``."""
    orders = multi_index.array
    derived = fn
    if input_shape == ():
        for _ in range(int(orders)):
            derived = _jvp_along(derived, None, input_shape)
    else:
        for index in np.ndindex(input_shape):
            for _ in range(int(orders[index])):
                derived = _jvp_along(derived, index, input_shape)
    return derived


def _jvp_along(fn, index, input_shape):
    def dfn(x):
        # jvp takes no primal with overlapping memory (a broadcast view).
        x = x.contiguous()
        tangent = _unit_direction(input_shape, index, x).expand(x.shape).contiguous()
        return torch.func.jvp(fn, (x,), (tangent,))[1]

    return dfn


class DiffopFunction(Function):
    """``L f`` computed by forward-mode autodiff."""

    def __init__(self, coeffs: PartialDerivativeCoefficients, f: Function):
        self._coeffs = coeffs
        self._f = f
        super().__init__(coeffs.input_domain_shape, ())

    def _evaluate(self, x):
        out = None
        for codomain_idx, multi_index, coeff in self._coeffs.items_flat():

            def component(xx, idx=codomain_idx):
                vals = self._f._evaluate(xx)
                return vals[(Ellipsis,) + idx] if idx else vals

            term = coeff * nested_derivative(component, multi_index, self._coeffs.input_domain_shape)(x)
            out = term if out is None else out + term
        return out


def _differentiated(poly: Polynomial, coeffs: PartialDerivativeCoefficients) -> Polynomial:
    """``sum_k c_k d^k poly`` for a univariate coefficient table."""
    result = None
    for _, multi_index, coeff in coeffs.items_flat():
        p = poly
        for _ in range(multi_index.order):
            p = p.differentiate()
        term = coeff * p
        result = term if result is None else result + term
    return result


def apply_diffop_to_function(coeffs: PartialDerivativeCoefficients, f: Function) -> Function:
    """Apply a coefficient-table diffop to a function, with the exact
    shortcuts: ``Zero`` stays zero; a ``Constant`` keeps only the order-0
    terms; a univariate polynomial, or a piecewise one piece by piece (a.e.),
    is differentiated symbolically; anything else becomes a
    :class:`DiffopFunction`."""
    if isinstance(f, Zero):
        return Zero(coeffs.input_domain_shape, ())
    if isinstance(f, Constant):
        value = None
        for codomain_idx, multi_index, coeff in coeffs.items_flat():
            if multi_index.order == 0:
                term = coeff * (f.value[codomain_idx] if codomain_idx else f.value)
                value = term if value is None else value + term
        if value is None:
            return Zero(coeffs.input_domain_shape, ())
        return Constant(coeffs.input_domain_shape, value)
    univariate = coeffs.input_domain_shape == () and list(coeffs.keys()) == [()]
    if univariate and isinstance(f, Polynomial):
        return _differentiated(f, coeffs)
    if univariate and isinstance(f, Piecewise) and all(isinstance(p, Polynomial) for p in f.pieces):
        return Piecewise(f.xs, [_differentiated(p, coeffs) for p in f.pieces])
    return DiffopFunction(coeffs, f)


class AutodiffTransformedKernel(CovarianceFunction):
    """``L0 k L1*`` computed by nested forward-mode autodiff through the
    kernel's own ``_evaluate``.

    Exact for kernels smooth at coincidence (ExpQuad); for kernels defined
    through ``|x0 - x1|`` (Matérn) the diagonal needs the closed forms of
    ``product.py`` / ``radial.py``, and this class serves off the diagonal
    (and as their test oracle)."""

    def __init__(self, base: CovarianceFunction, coeffs0, coeffs1):
        super().__init__(base.input_shape)
        self.base = base
        self.coeffs0 = coeffs0
        self.coeffs1 = coeffs1

    def _evaluate(self, x0, x1):
        input_shape = self.base.input_shape
        x0, x1 = torch.as_tensor(x0), torch.as_tensor(x1)
        batch = torch.broadcast_shapes(
            x0.shape[: x0.ndim - len(input_shape)], x1.shape[: x1.ndim - len(input_shape)]
        )
        x0 = x0.expand(batch + input_shape)
        x1 = x1.expand(batch + input_shape)

        def terms(coeffs):
            return [((), None, 1.0)] if coeffs is None else list(coeffs.items_flat())

        out = None
        for ci0, mi0, c0 in terms(self.coeffs0):
            for ci1, mi1, c1 in terms(self.coeffs1):

                def base_fn(a0, a1, i0=ci0, i1=ci1):
                    vals = self.base._evaluate(a0, a1)
                    return vals[(Ellipsis,) + tuple(i0) + tuple(i1)] if (i0 or i1) else vals

                fn = base_fn
                if mi0 is not None and mi0.order > 0:

                    def fn0(a0, a1, inner=fn, mi=mi0):
                        return nested_derivative(lambda z: inner(z, a1), mi, input_shape)(a0)

                    fn = fn0
                if mi1 is not None and mi1.order > 0:

                    def fn1(a0, a1, inner=fn, mi=mi1):
                        return nested_derivative(lambda z: inner(a0, z), mi, input_shape)(a1)

                    fn = fn1
                term = (c0 * c1) * fn(x0, x1)
                out = term if out is None else out + term
        return out
