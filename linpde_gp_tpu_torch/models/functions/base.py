"""Shape-checked functions on torch tensors.

Port of ``linpde_gp_tpu/models/functions/base.py``: ``Function`` (``:19``)
with batched evaluation and its arithmetic (``:71``: sums, scalar
multiples, negation), ``LambdaFunction`` (``:111``) and ``Zero``
(``:132``).  Every function evaluates on the device and in the dtype of
its input.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.shapes import ShapeType, as_shape


class Function:
    """Callable with declared ``input_shape`` and ``output_shape``.

    ``__call__`` is batched: for input of shape ``batch + input_shape`` it
    returns ``batch + output_shape``.  Subclasses implement ``_evaluate``
    with exactly these semantics, on torch tensors.
    """

    def __init__(self, input_shape, output_shape=()) -> None:
        self._input_shape: ShapeType = as_shape(input_shape)
        self._output_shape: ShapeType = as_shape(output_shape)

    @property
    def input_shape(self) -> ShapeType:
        return self._input_shape

    @property
    def input_ndim(self) -> int:
        return len(self._input_shape)

    @property
    def output_shape(self) -> ShapeType:
        return self._output_shape

    @property
    def output_ndim(self) -> int:
        return len(self._output_shape)

    def __call__(self, x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))  # Python floats: float64
        batch_ndim = x.ndim - self.input_ndim
        if batch_ndim < 0 or tuple(x.shape[batch_ndim:]) != self._input_shape:
            raise ValueError(
                f"Input of shape {tuple(x.shape)} is not compatible with input_shape {self._input_shape}."
            )
        out = self._evaluate(x)
        expected = tuple(x.shape[:batch_ndim]) + self._output_shape
        if tuple(out.shape) != expected:
            out = out.reshape(expected)
        return out

    def _evaluate(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- arithmetic -------------------------------------------------------
    def __add__(self, other):
        from .arithmetic import SumFunction, asfunction

        if isinstance(other, (int, float, np.ndarray, torch.Tensor)) or np.isscalar(other):
            from .basic import Constant

            other = Constant(self.input_shape, other, output_shape=self.output_shape)
        if isinstance(other, Zero):
            return self
        if isinstance(self, Zero):
            return other
        return SumFunction(self, asfunction(other, self.input_shape))

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self.__add__(-other if isinstance(other, Function) else -1.0 * other)

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        return -1.0 * self

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            from .arithmetic import ScaledFunction

            return ScaledFunction(self, scalar)
        return NotImplemented

    def __rmul__(self, scalar):
        return self.__mul__(scalar)

    def __truediv__(self, scalar):
        return self.__mul__(1.0 / scalar)


class LambdaFunction(Function):
    """A function from a callable on torch tensors.  ``vectorized=False``:
    ``fn`` takes one point of ``input_shape`` and is mapped over the batch
    by ``torch.func.vmap``."""

    def __init__(self, fn, input_shape, output_shape=(), vectorized: bool = True):
        super().__init__(input_shape, output_shape)
        self._fn = fn
        self._vectorized = vectorized

    def _evaluate(self, x):
        fn = self._fn
        if not self._vectorized:
            for _ in range(x.ndim - self.input_ndim):
                fn = torch.func.vmap(fn)
        return torch.as_tensor(fn(x), device=x.device)


class Zero(Function):
    """The zero function."""

    def _evaluate(self, x):
        batch_shape = tuple(x.shape[: x.ndim - self.input_ndim])
        return torch.zeros(batch_shape + self.output_shape, dtype=x.dtype, device=x.device)

    def __rmul__(self, scalar):
        return self

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            return self
        return NotImplemented
