"""Concrete deterministic functions.

Port of ``linpde_gp_tpu/models/functions/basic.py``: ``Constant``,
``Affine``, ``Piecewise``, ``PiecewiseLinear``, ``PiecewiseConstant``,
``TruncatedSineSeries`` (the heat equation's initial conditions),
``TruncatedGaussianMixturePDF`` (normalized by ``scipy.stats`` on the host
at construction), ``StackedFunction`` and ``stack``.  Parameters are kept
as float64 numpy arrays; evaluation runs on the input's device and dtype.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .base import Function
from .polynomial import Polynomial


def _like(a, x: torch.Tensor) -> torch.Tensor:
    """The numpy array ``a`` as a tensor of ``x``'s dtype and device."""
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=x.dtype, device=x.device)


class Constant(Function):
    def __init__(self, input_shape, value, output_shape=None):
        value = np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value, dtype=np.float64)
        if output_shape is None:
            output_shape = value.shape
        super().__init__(input_shape, output_shape)
        self._value = np.broadcast_to(value, self.output_shape)

    @property
    def value(self) -> np.ndarray:
        return self._value

    def _evaluate(self, x):
        batch_shape = tuple(x.shape[: x.ndim - self.input_ndim])
        return _like(self._value, x).expand(batch_shape + self.output_shape)

    def __add__(self, other):
        if isinstance(other, Constant) and other.input_shape == self.input_shape:
            return Constant(self.input_shape, self._value + other.value)
        return super().__add__(other)

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            return Constant(self.input_shape, self._value * float(scalar))
        return super().__mul__(scalar)

    __rmul__ = __mul__


class Affine(Function):
    """``f(x) = A @ x + b`` (scalar case: ``a * x + b``)."""

    def __init__(self, A, b):
        self._A = np.asarray(A, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        if self._A.ndim == 0:
            input_shape, output_shape = (), self._b.shape
        elif self._A.ndim == 1:
            input_shape, output_shape = (self._A.shape[0],), ()
        else:
            input_shape, output_shape = (self._A.shape[1],), (self._A.shape[0],)
        super().__init__(input_shape, output_shape)

    @property
    def A(self) -> np.ndarray:
        return self._A

    @property
    def b(self) -> np.ndarray:
        return self._b

    def _evaluate(self, x):
        A, b = _like(self._A, x), _like(self._b, x)
        if self._A.ndim == 0:
            return A * x + b
        return torch.tensordot(x, A.T if self._A.ndim == 2 else A, dims=1) + b


class Piecewise(Function):
    """Scalar piecewise function on a partition ``xs``: piece ``i`` on
    ``(xs[i], xs[i + 1]]`` (the first piece also at ``xs[0]``), zero
    outside."""

    def __init__(self, xs, fns: Iterable[Function]):
        xs = np.atleast_1d(np.asarray(xs))
        if xs.ndim != 1:
            raise ValueError("`xs` must be one-dimensional")
        self._xs = xs
        fns = tuple(fns)
        if len(fns) != xs.size - 1:
            raise ValueError("need len(xs) - 1 pieces")
        if not all(f.input_shape == () and f.output_shape == () for f in fns):
            raise ValueError("pieces must be scalar functions")
        self._fns = fns
        super().__init__((), ())

    @property
    def xs(self) -> np.ndarray:
        return self._xs

    @property
    def pieces(self):
        return self._fns

    @property
    def num_pieces(self) -> int:
        return len(self._fns)

    def _evaluate(self, x):
        out = torch.zeros_like(x)
        for i, fn in enumerate(self._fns):
            lo, hi = float(self._xs[i]), float(self._xs[i + 1])
            mask = ((lo <= x) if i == 0 else (lo < x)) & (x <= hi)
            out = torch.where(mask, fn._evaluate(x), out)
        return out

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            return type(self)._scaled(self, scalar)
        return super().__mul__(scalar)

    __rmul__ = __mul__

    def __add__(self, other):
        # Piecewise + polynomial (or constant) stays piecewise: the exact
        # piecewise-polynomial right-hand sides of the Poisson problems.
        if isinstance(other, Constant):
            other = Polynomial((float(np.asarray(other.value)),))
        if np.ndim(other) == 0 and not isinstance(other, Function):
            other = Polynomial((float(other),))
        if isinstance(other, Polynomial):
            return Piecewise(self.xs, [p + other for p in self.pieces])
        return super().__add__(other)

    __radd__ = __add__

    @staticmethod
    def _scaled(piecewise, scalar):
        return Piecewise(piecewise.xs, [scalar * p for p in piecewise.pieces])


class PiecewiseLinear(Piecewise):
    @staticmethod
    def from_points(xs, ys) -> "PiecewiseLinear":
        xs, ys = np.asarray(xs), np.asarray(ys)
        pieces = []
        for l, r, y_l, y_r in zip(xs[:-1], xs[1:], ys[:-1], ys[1:]):  # noqa: E741
            slope = (y_r - y_l) / (r - l)
            pieces.append(Polynomial((y_l - slope * l, slope)))
        return PiecewiseLinear(xs=xs, fns=pieces)

    @staticmethod
    def _scaled(piecewise, scalar):
        return PiecewiseLinear(piecewise.xs, [scalar * p for p in piecewise.pieces])


class PiecewiseConstant(Piecewise):
    def __init__(self, xs, ys):
        ys = np.atleast_1d(np.asarray(ys))
        self._ys = ys
        super().__init__(xs, [Constant((), y) for y in ys])

    @property
    def ys(self) -> np.ndarray:
        return self._ys


class TruncatedSineSeries(Function):
    """``f(x) = sum_k c_k sin(k pi (x - l) / (r - l))`` on an interval
    ``[l, r]``: the heat equation's initial conditions."""

    def __init__(self, domain, coefficients):
        from ..domains import asdomain

        self._domain = asdomain(domain)
        super().__init__(self._domain.shape, ())
        coefficients = np.asarray(coefficients, dtype=np.float64)
        if coefficients.ndim != 1:
            raise ValueError("coefficients must be one-dimensional")
        self._coefficients = coefficients

    @property
    def domain(self):
        return self._domain

    @property
    def coefficients(self) -> np.ndarray:
        return self._coefficients

    @property
    def half_angular_frequencies(self) -> np.ndarray:
        l, r = self._domain  # noqa: E741
        return np.pi * np.arange(1, self._coefficients.shape[-1] + 1) / (r - l)

    def _evaluate(self, x):
        l, _ = self._domain  # noqa: E741
        w = _like(self.half_angular_frequencies, x)
        return torch.sum(_like(self._coefficients, x) * torch.sin(w * (x[..., None] - float(l))), dim=-1)


class TruncatedGaussianMixturePDF(Function):
    """The density of a Gaussian mixture truncated to an interval (zero
    outside it), normalized by ``scipy.stats.norm.cdf`` on the host."""

    def __init__(self, domain, means, stds, weights=None):
        from scipy import stats

        from ..domains import asdomain

        self._domain = asdomain(domain)
        super().__init__((), ())
        self._means = np.atleast_1d(np.asarray(means, dtype=np.float64))
        self._stds = np.broadcast_to(np.asarray(stds, dtype=np.float64), self._means.shape)
        n = self._means.shape[0]
        if weights is None:
            weights = np.full((n,), 1.0 / n)
        self._weights = np.asarray(weights, dtype=np.float64)
        a, b = self._domain
        mass = stats.norm.cdf((float(b) - self._means) / self._stds) - stats.norm.cdf(
            (float(a) - self._means) / self._stds
        )
        self._norms = self._weights / (mass * self._stds * np.sqrt(2 * np.pi))

    def _evaluate(self, x):
        z = (x[..., None] - _like(self._means, x)) / _like(self._stds, x)
        vals = torch.sum(_like(self._norms, x) * torch.exp(-0.5 * z**2), dim=-1)
        a, b = self._domain
        inside = (x >= float(a)) & (x <= float(b))
        return torch.where(inside, vals, torch.zeros_like(vals))


class StackedFunction(Function):
    """Scalar-output functions stacked into one multi-output function."""

    def __init__(self, *fns: Function):
        fns = tuple(fns)
        input_shape = fns[0].input_shape
        if not all(f.input_shape == input_shape for f in fns):
            raise ValueError("All stacked functions must share an input shape.")
        if not all(f.output_shape == () for f in fns):
            raise ValueError("Can only stack scalar-output functions.")
        self._fns = fns
        super().__init__(input_shape, (len(fns),))

    @property
    def fns(self):
        return self._fns

    def _evaluate(self, x):
        return torch.stack([f._evaluate(x) for f in self._fns], dim=-1)


def stack(fns: Sequence[Function]) -> StackedFunction:
    return StackedFunction(*fns)
