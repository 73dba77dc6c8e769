"""Shape-checked functions on torch tensors.

Port of ``linpde_gp_tpu/models/functions/base.py`` (``Function`` ``:19``,
``Zero`` ``:132``), cut to what the conditioning path reads: the shapes,
batched evaluation and the zero function.  Function arithmetic
(sums, constants, lambdas) comes with ROADMAP Queue 1 item 9b.
"""

from __future__ import annotations

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
        x = torch.as_tensor(x)
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


class Zero(Function):
    """The zero function."""

    def _evaluate(self, x):
        batch_shape = tuple(x.shape[: x.ndim - self.input_ndim])
        return torch.zeros(batch_shape + self.output_shape, dtype=x.dtype, device=x.device)
