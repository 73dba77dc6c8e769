"""Linear differential operators.

Port of ``linpde_gp_tpu/ops/diffops/lindiffop.py``: every operator is a
coefficient table (``coefficients.py``), and the kernel transformation
rules consume only that table.  ``weak_form`` gives the FEM weak-form
functional of an operator on a test basis (the Laplacian and its scaled
forms on the hat basis).
"""

from __future__ import annotations

import numpy as np

from ...utils.shapes import as_shape
from .coefficients import MultiIndex, PartialDerivativeCoefficients
from .linfuncop import LinearFunctionOperator


class LinearDifferentialOperator(LinearFunctionOperator):
    """A linear differential operator with scalar output codomain."""

    def __init__(self, coefficients: PartialDerivativeCoefficients):
        self._coefficients = coefficients
        super().__init__(
            input_shapes=(coefficients.input_domain_shape, coefficients.input_codomain_shape),
            output_shapes=(coefficients.input_domain_shape, ()),
        )

    @property
    def coefficients(self) -> PartialDerivativeCoefficients:
        return self._coefficients

    def to_sum(self):
        """``(codomain_idx, multi_index, coeff)`` terms."""
        return tuple(self._coefficients.items_flat())

    def weak_form(self, test_basis):
        """The weak-form functional on ``test_basis``; none is registered
        for a general operator."""
        raise NotImplementedError(f"No weak form registered for {type(self).__name__}.")

    def __rmul__(self, other):
        if np.ndim(other) == 0:
            return ScaledLinearDifferentialOperator(self, float(other))
        return NotImplemented

    __mul__ = __rmul__

    def __repr__(self):
        return f"{type(self).__name__}({self._coefficients!r})"


class ScaledLinearDifferentialOperator(LinearDifferentialOperator):
    """``alpha * D``, keeping the inner operator."""

    def __init__(self, lindiffop: LinearDifferentialOperator, scalar):
        super().__init__(float(scalar) * lindiffop.coefficients)
        self._lindiffop = lindiffop
        self._scalar = float(scalar)

    @property
    def lindiffop(self) -> LinearDifferentialOperator:
        return self._lindiffop

    @property
    def scalar(self) -> float:
        return self._scalar

    def weak_form(self, test_basis):
        return self._scalar * self._lindiffop.weak_form(test_basis)

    def __repr__(self):
        return f"{self._scalar} * {self._lindiffop!r}"


class PartialDerivative(LinearDifferentialOperator):
    """``d^alpha`` for a multi-index ``alpha``."""

    def __init__(self, multi_index):
        multi_index = MultiIndex(multi_index)
        super().__init__(
            PartialDerivativeCoefficients(
                {(): {multi_index: 1.0}}, input_domain_shape=multi_index.shape, input_codomain_shape=()
            )
        )
        self._multi_index = multi_index

    @property
    def multi_index(self) -> MultiIndex:
        return self._multi_index

    @property
    def order(self) -> int:
        return self._multi_index.order

    def __repr__(self):
        return f"PartialDerivative({self._multi_index!r})"


class Derivative(PartialDerivative):
    """``d^n/dx^n`` on scalar domains."""

    def __init__(self, order: int = 1):
        if order < 0:
            raise ValueError("order must be non-negative")
        super().__init__(MultiIndex(np.asarray(int(order))))


class TimeDerivative(LinearDifferentialOperator):
    """``d/dt`` where time is the first coordinate."""

    def __init__(self, domain_shape):
        domain_shape = as_shape(domain_shape)
        if domain_shape == ():
            multi_index = MultiIndex(np.asarray(1))
        else:
            if len(domain_shape) != 1:
                raise ValueError(f"TimeDerivative needs a scalar or 1-D domain, got {domain_shape}")
            multi_index = MultiIndex.from_index((0,), domain_shape, 1)
        super().__init__(PartialDerivativeCoefficients({(): {multi_index: 1.0}}, domain_shape, ()))


class DirectionalDerivative(LinearDifferentialOperator):
    """``f -> <direction, grad f>``."""

    def __init__(self, direction):
        direction = np.asarray(direction, dtype=np.float64)
        domain_shape = direction.shape
        if direction.ndim == 0:
            coeffs = {(): {MultiIndex(np.asarray(1)): float(direction)}}
        else:
            coeffs = {
                (): {
                    MultiIndex.from_index(idx, domain_shape, 1): float(direction[idx])
                    for idx in np.ndindex(domain_shape)
                    if direction[idx] != 0.0
                }
            }
            if not coeffs[()]:
                coeffs = {(): {MultiIndex(np.zeros(domain_shape, int)): 0.0}}
        super().__init__(PartialDerivativeCoefficients(coeffs, domain_shape, ()))
        self._direction = direction

    @property
    def direction(self) -> np.ndarray:
        return self._direction


class WeightedLaplacian(LinearDifferentialOperator):
    """``f -> sum_i w_i d^2_i f``."""

    def __init__(self, weights):
        weights = np.asarray(weights, dtype=np.float64)
        domain_shape = weights.shape
        if weights.ndim == 0:
            coeffs = {(): {MultiIndex(np.asarray(2)): float(weights)}}
        else:
            coeffs = {
                (): {
                    MultiIndex.from_index(idx, domain_shape, 2): float(weights[idx])
                    for idx in np.ndindex(domain_shape)
                    if weights[idx] != 0.0
                }
            }
            if not coeffs[()]:
                coeffs = {(): {MultiIndex(np.zeros(domain_shape, int)): 0.0}}
        super().__init__(PartialDerivativeCoefficients(coeffs, domain_shape, ()))
        self._weights = weights

    @property
    def weights(self) -> np.ndarray:
        return self._weights


class Laplacian(WeightedLaplacian):
    """The Laplacian on ``domain_shape`` inputs.

    >>> import torch
    >>> import linpde_gp_tpu_torch as lgt
    >>> D = Laplacian(())
    >>> f = lgt.functions.Polynomial([0.0, 0.0, 1.0])  # x**2
    >>> float(D(f)(torch.tensor(0.7, dtype=torch.float64)))  # (x**2)'' == 2
    2.0
    """

    def __init__(self, domain_shape):
        super().__init__(np.ones(as_shape(domain_shape)))

    def weak_form(self, test_basis):
        from ...models.functions.fem import UnivariateLinearInterpolationBasis
        from ..functionals.weak_forms import WeakForm_Laplacian_UnivariateInterpolationBasis

        if isinstance(test_basis, UnivariateLinearInterpolationBasis):
            return WeakForm_Laplacian_UnivariateInterpolationBasis(test_basis)
        raise NotImplementedError(f"No weak form for test basis {type(test_basis).__name__}.")


class SpatialLaplacian(WeightedLaplacian):
    """Laplacian over the non-time coordinates of a space-time domain."""

    def __init__(self, domain_shape):
        domain_shape = as_shape(domain_shape)
        if len(domain_shape) != 1 or domain_shape[0] < 2:
            raise ValueError(f"SpatialLaplacian needs a 1-D space-time domain of size >= 2, got {domain_shape}")
        weights = np.ones(domain_shape)
        weights[0] = 0.0
        super().__init__(weights)


def HeatOperator(domain_shape, alpha=1.0) -> LinearDifferentialOperator:
    """``d/dt - alpha * Laplace_x``, fused into one coefficient table."""
    domain_shape = as_shape(domain_shape)
    lap = SpatialLaplacian(domain_shape)
    time_deriv = TimeDerivative(domain_shape)
    return LinearDifferentialOperator(time_deriv.coefficients + (-float(alpha)) * lap.coefficients)
