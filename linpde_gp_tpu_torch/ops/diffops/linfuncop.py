"""Linear function operators (function -> function) and their algebra.

Port of ``linpde_gp_tpu/ops/diffops/linfuncop.py``: shapes, sums,
scalings, compositions, the identity and output selection, and
``to_linfunctl``.  Calling an operator applies it through the rule engine
(``ops/transforms/dispatch.py``).
"""

from __future__ import annotations

import numpy as np

from ...utils.shapes import ShapeType, as_shape


class LinearFunctionOperator:
    """Linear map between function spaces."""

    def __init__(self, input_shapes, output_shapes) -> None:
        input_domain, input_codomain = input_shapes
        output_domain, output_codomain = output_shapes
        self._input_domain_shape = as_shape(input_domain)
        self._input_codomain_shape = as_shape(input_codomain)
        self._output_domain_shape = as_shape(output_domain)
        self._output_codomain_shape = as_shape(output_codomain)

    @property
    def input_shapes(self):
        return (self._input_domain_shape, self._input_codomain_shape)

    @property
    def input_domain_shape(self) -> ShapeType:
        return self._input_domain_shape

    @property
    def input_codomain_shape(self) -> ShapeType:
        return self._input_codomain_shape

    @property
    def output_shapes(self):
        return (self._output_domain_shape, self._output_codomain_shape)

    @property
    def output_domain_shape(self) -> ShapeType:
        return self._output_domain_shape

    @property
    def output_codomain_shape(self) -> ShapeType:
        return self._output_codomain_shape

    def __call__(self, obj, /, **kwargs):
        from ..transforms.dispatch import apply_operator

        return apply_operator(self, obj, **kwargs)

    def to_linfunctl(self, X, device=None):
        """The functional ``f -> (L f)(X)`` (``linfuncop.py:60-69`` of the JAX
        package), with ``X`` on ``device`` (see ``_EvaluationFunctional``)."""
        from ..functionals.evaluation import _EvaluationFunctional

        return (
            _EvaluationFunctional(self.output_domain_shape, self.output_codomain_shape, X, device=device) @ self
        )

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, LinearFunctionOperator):
            return SumLinearFunctionOperator(self, other)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, LinearFunctionOperator):
            return SumLinearFunctionOperator(self, -other)
        return NotImplemented

    def __neg__(self):
        return -1.0 * self

    def __rmul__(self, other):
        if np.ndim(other) == 0:
            return ScaledLinearFunctionOperator(self, other)
        return NotImplemented

    __mul__ = __rmul__

    def __matmul__(self, other):
        if isinstance(other, SumLinearFunctionOperator):
            return SumLinearFunctionOperator(*(self @ s for s in other.summands))
        if isinstance(other, LinearFunctionOperator):
            return CompositeLinearFunctionOperator(self, other)
        return NotImplemented


class ScaledLinearFunctionOperator(LinearFunctionOperator):
    def __init__(self, linfuncop: LinearFunctionOperator, scalar):
        if isinstance(linfuncop, ScaledLinearFunctionOperator):
            scalar = scalar * linfuncop.scalar
            linfuncop = linfuncop.linfuncop
        self._linfuncop = linfuncop
        self._scalar = float(scalar)
        super().__init__(linfuncop.input_shapes, linfuncop.output_shapes)

    @property
    def linfuncop(self) -> LinearFunctionOperator:
        return self._linfuncop

    @property
    def scalar(self) -> float:
        return self._scalar

    def __repr__(self):
        return f"{self._scalar} * {self._linfuncop!r}"


class SumLinearFunctionOperator(LinearFunctionOperator):
    def __init__(self, *summands: LinearFunctionOperator):
        flat = []
        for s in summands:
            if isinstance(s, SumLinearFunctionOperator):
                flat.extend(s.summands)
            else:
                flat.append(s)
        self._summands = tuple(flat)
        first = flat[0]
        if not all(s.input_shapes == first.input_shapes and s.output_shapes == first.output_shapes for s in flat):
            raise ValueError("Summand shapes do not match.")
        super().__init__(first.input_shapes, first.output_shapes)

    @property
    def summands(self):
        return self._summands

    def __repr__(self):
        return " + ".join(repr(s) for s in self._summands)


class CompositeLinearFunctionOperator(LinearFunctionOperator):
    """``(L1 @ L0)[f] = L1[L0[f]]``."""

    def __init__(self, *linfuncops: LinearFunctionOperator):
        flat = []
        for op in linfuncops:
            if isinstance(op, CompositeLinearFunctionOperator):
                flat.extend(op.linfuncops)
            else:
                flat.append(op)
        self._linfuncops = tuple(flat)
        for outer, inner in zip(flat[:-1], flat[1:]):
            if outer.input_shapes != inner.output_shapes:
                raise ValueError("Composition shapes do not match.")
        super().__init__(flat[-1].input_shapes, flat[0].output_shapes)

    @property
    def linfuncops(self):
        return self._linfuncops

    def __repr__(self):
        return " @ ".join(repr(op) for op in self._linfuncops)


class Identity(LinearFunctionOperator):
    def __init__(self, domain_shape, codomain_shape=()):
        super().__init__((domain_shape, codomain_shape), (domain_shape, codomain_shape))

    def __repr__(self):
        return "Identity()"


class SelectOutput(LinearFunctionOperator):
    """Select one output component of a multi-output function."""

    def __init__(self, input_shapes, idx):
        input_domain, input_codomain = input_shapes
        self._idx = tuple(np.atleast_1d(np.asarray(idx, dtype=int)))
        super().__init__((input_domain, input_codomain), (input_domain, ()))

    @property
    def idx(self):
        return self._idx

    def __repr__(self):
        return f"SelectOutput(idx={self._idx})"
