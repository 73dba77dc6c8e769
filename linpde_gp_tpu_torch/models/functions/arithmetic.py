"""Function arithmetic: sums, scalar multiples and products of functions.

Port of ``linpde_gp_tpu/models/functions/arithmetic.py``."""

from __future__ import annotations

import numpy as np

from .base import Function, LambdaFunction, Zero


class SumFunction(Function):
    def __init__(self, *summands: Function):
        flat = []
        for s in summands:
            if isinstance(s, SumFunction):
                flat.extend(s.summands)
            elif not isinstance(s, Zero):
                flat.append(s)
        if not flat:
            flat = [summands[0]]
        self._summands = tuple(flat)
        super().__init__(flat[0].input_shape, flat[0].output_shape)

    @property
    def summands(self):
        return self._summands

    def _evaluate(self, x):
        out = self._summands[0]._evaluate(x)
        for s in self._summands[1:]:
            out = out + s._evaluate(x)
        return out


class ScaledFunction(Function):
    def __init__(self, function: Function, scalar):
        if isinstance(function, ScaledFunction):
            scalar = scalar * function.scalar
            function = function.function
        self._function = function
        self._scalar = float(scalar)
        super().__init__(function.input_shape, function.output_shape)

    @property
    def function(self) -> Function:
        return self._function

    @property
    def scalar(self) -> float:
        return self._scalar

    def _evaluate(self, x):
        return self._scalar * self._function._evaluate(x)


class ProductFunction(Function):
    def __init__(self, *factors: Function):
        self._factors = tuple(factors)
        super().__init__(factors[0].input_shape, factors[0].output_shape)

    def _evaluate(self, x):
        out = self._factors[0]._evaluate(x)
        for f in self._factors[1:]:
            out = out * f._evaluate(x)
        return out


def asfunction(obj, input_shape=None) -> Function:
    """``obj`` as a :class:`Function`: a function as it is, a callable as a
    :class:`LambdaFunction` on ``input_shape``, a scalar as a constant."""
    from .basic import Constant

    if isinstance(obj, Function):
        return obj
    if callable(obj):
        if input_shape is None:
            raise ValueError("input_shape required to wrap a callable")
        return LambdaFunction(obj, input_shape)
    if np.ndim(obj) == 0:
        return Constant(input_shape if input_shape is not None else (), obj)
    raise TypeError(f"Cannot interpret {obj!r} as a Function.")
