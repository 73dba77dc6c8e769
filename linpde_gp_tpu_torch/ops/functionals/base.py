"""Linear functionals (function -> finite vector).

Port of ``linpde_gp_tpu/ops/functionals/base.py``: ``Discretization``
(``:31``), ``LinearFunctional`` (``:43``) and the scaled (``:145``), sum
(``:177``) and composite (``:206``) functionals.  A functional exposes a
discretization ``(points, weights, codomain_first)``:

    L[f]_j = sum_q weights[j, q] f(points_q)          (weights given)
    L[f]   = f(points) reshaped per layout            (pointwise)

so every Gram and cross-covariance contraction is a weighted pairwise
kernel product.  Points and weights are float64 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...utils.shapes import ShapeType, as_shape, size


@dataclass
class Discretization:
    """Weighted-point-evaluation form of a functional."""

    points: torch.Tensor  # (nq,) + input_domain_shape
    weights: torch.Tensor | None  # (output_size, nq * c), or None for pointwise
    codomain_first: bool = True  # multi-output flattening order

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


class LinearFunctional:
    """Linear map from a function space to R^output_shape."""

    def __init__(self, input_shapes, output_shape) -> None:
        input_domain, input_codomain = input_shapes
        self._input_domain_shape = as_shape(input_domain)
        self._input_codomain_shape = as_shape(input_codomain)
        self._output_shape = as_shape(output_shape)

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
    def output_shape(self) -> ShapeType:
        return self._output_shape

    @property
    def output_ndim(self) -> int:
        return len(self._output_shape)

    @property
    def output_size(self) -> int:
        return size(self._output_shape)

    def __call__(self, obj, /, **kwargs):
        from ..transforms.functionals import apply_functional

        return apply_functional(self, obj, **kwargs)

    # -- core protocol ---------------------------------------------------
    def discretization(self) -> Discretization:
        raise NotImplementedError(f"{type(self).__name__} does not expose a discretization.")

    def apply_to_function(self, f) -> torch.Tensor:
        """Contract through the discretization: ``weights`` (when given)
        acts on ``f(points)`` flattened point-major, codomain-minor."""
        disc = self.discretization()
        vals = f(disc.points)  # (nq,) + codomain
        if disc.weights is None:
            if self._input_codomain_shape != () and disc.codomain_first:
                vals = torch.movedim(vals.reshape((disc.num_points, -1)), -1, 0)
            return vals.reshape(self._output_shape)
        return (disc.weights @ vals.reshape(-1)).reshape(self._output_shape)

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, LinearFunctional):
            return SumLinearFunctional(self, other)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, LinearFunctional):
            return SumLinearFunctional(self, -1.0 * other)
        return NotImplemented

    def __neg__(self):
        return -1.0 * self

    def __rmul__(self, other):
        if np.ndim(other) == 0:
            return ScaledLinearFunctional(self, other)
        return NotImplemented

    __mul__ = __rmul__

    def __matmul__(self, other):
        """``L @ T``: pre-compose with a function operator."""
        from ..diffops.linfuncop import LinearFunctionOperator

        if isinstance(other, LinearFunctionOperator):
            return CompositeLinearFunctional(None, self, other)
        return NotImplemented

    def __rmatmul__(self, other):
        """``A @ L``: post-compose with a matrix or linear operator."""
        from ..linalg.linops import LinearOperator, aslinop

        if isinstance(other, (np.ndarray, torch.Tensor, LinearOperator)):
            return CompositeLinearFunctional(aslinop(other), self, None)
        return NotImplemented


class ScaledLinearFunctional(LinearFunctional):
    def __init__(self, linfunctl: LinearFunctional, scalar):
        if isinstance(linfunctl, ScaledLinearFunctional):
            scalar = scalar * linfunctl.scalar
            linfunctl = linfunctl.linfunctl
        self._linfunctl = linfunctl
        self._scalar = float(scalar)
        super().__init__(linfunctl.input_shapes, linfunctl.output_shape)

    @property
    def linfunctl(self) -> LinearFunctional:
        return self._linfunctl

    @property
    def scalar(self) -> float:
        return self._scalar

    def discretization(self) -> Discretization:
        disc = self._linfunctl.discretization()
        if disc.weights is None:
            # Pointwise: scale through explicit weights, which keep the layout.
            n = disc.num_points * size(self._input_codomain_shape)
            weights = self._scalar * torch.eye(n, dtype=disc.points.dtype, device=disc.points.device)
            return Discretization(disc.points, weights, disc.codomain_first)
        return Discretization(disc.points, self._scalar * disc.weights, disc.codomain_first)

    def apply_to_function(self, f):
        return self._scalar * self._linfunctl.apply_to_function(f)


class SumLinearFunctional(LinearFunctional):
    def __init__(self, *summands: LinearFunctional):
        flat = []
        for s in summands:
            if isinstance(s, SumLinearFunctional):
                flat.extend(s.summands)
            else:
                flat.append(s)
        self._summands = tuple(flat)
        first = flat[0]
        if not all(s.input_shapes == first.input_shapes and s.output_shape == first.output_shape for s in flat):
            raise ValueError("Summand shapes do not match.")
        super().__init__(first.input_shapes, first.output_shape)

    @property
    def summands(self):
        return self._summands

    def apply_to_function(self, f):
        out = None
        for s in self._summands:
            term = s.apply_to_function(f)
            out = term if out is None else out + term
        return out


class CompositeLinearFunctional(LinearFunctional):
    """``A o L o T``: a linear operator after a functional after a function
    operator (each optional)."""

    def __init__(self, linop, linfunctl: LinearFunctional, linfuncop):
        from ..diffops.linfuncop import LinearFunctionOperator
        from ..linalg.linops import LinearOperator

        # Flatten nested composites.
        if isinstance(linfunctl, CompositeLinearFunctional):
            inner = linfunctl
            if linop is None:
                linop = inner.linop
            elif inner.linop is not None:
                linop = linop @ inner.linop
            if linfuncop is None:
                linfuncop = inner.linfuncop
            elif inner.linfuncop is not None:
                linfuncop = inner.linfuncop @ linfuncop
            linfunctl = inner.linfunctl

        assert linop is None or isinstance(linop, LinearOperator)
        assert linfuncop is None or isinstance(linfuncop, LinearFunctionOperator)
        self._linop = linop
        self._linfunctl = linfunctl
        self._linfuncop = linfuncop
        input_shapes = linfuncop.input_shapes if linfuncop is not None else linfunctl.input_shapes
        output_shape = (linop.shape[0],) if linop is not None else linfunctl.output_shape
        super().__init__(input_shapes, output_shape)

    @property
    def linop(self):
        return self._linop

    @property
    def linfunctl(self) -> LinearFunctional:
        return self._linfunctl

    @property
    def linfuncop(self):
        return self._linfuncop

    def apply_to_function(self, f):
        if self._linfuncop is not None:
            f = self._linfuncop(f)
        vals = self._linfunctl.apply_to_function(f)
        if self._linop is not None:
            vals = self._linop @ vals.reshape(-1)
        return vals.reshape(self._output_shape)

    def __repr__(self):
        return f"Composite(linop={self._linop}, L={self._linfunctl!r}, T={self._linfuncop!r})"
