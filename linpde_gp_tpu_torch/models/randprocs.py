"""Random-process utilities: deterministic processes and coercion.

Port of ``linpde_gp_tpu/models/randprocs.py``.
"""

from __future__ import annotations

from .functions.base import Function


class DeterministicProcess:
    """A random process with zero covariance."""

    def __init__(self, fn: Function):
        self._fn = fn

    def as_fn(self) -> Function:
        return self._fn

    @property
    def mean(self) -> Function:
        return self._fn

    @property
    def input_shape(self):
        return self._fn.input_shape

    @property
    def output_shape(self):
        return self._fn.output_shape

    def __call__(self, x):
        from .randvars import Constant

        return Constant(self._fn(x))


def asrandproc(obj):
    from .gp import GaussianProcess

    if isinstance(obj, (GaussianProcess, DeterministicProcess)):
        return obj
    if isinstance(obj, Function):
        return DeterministicProcess(obj)
    if callable(obj):
        raise ValueError("Wrap callables as Functions first (input shape needed).")
    raise TypeError(f"Cannot interpret {obj!r} as a random process.")
