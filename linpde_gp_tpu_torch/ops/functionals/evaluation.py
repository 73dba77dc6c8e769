"""Point-evaluation functionals.

Port of ``linpde_gp_tpu/ops/functionals/evaluation.py``:
``_EvaluationFunctional`` (``:19``, output layout ``codomain_shape +
X_batch_shape``, the multi-output Gram flattening contract) and
``DiracFunctional`` (``:69``, layout ``X_batch_shape + codomain_shape``).
The layout asymmetry is deliberate and kept.  ``X`` is held as a float64
tensor on ``device`` (``None``: a tensor's own device, else the default
device), where the JAX package holds a numpy array.
"""

from __future__ import annotations

import torch

from ...config import as_f64
from ...utils.shapes import as_shape
from .base import Discretization, LinearFunctional


class _PointFunctional(LinearFunctional):
    """Shared state of the two evaluation functionals."""

    codomain_first = True

    def __init__(self, input_domain_shape, input_codomain_shape, X, device=None) -> None:
        input_domain_shape = as_shape(input_domain_shape)
        input_codomain_shape = as_shape(input_codomain_shape)
        self._X = as_f64(X, device)
        batch_ndim = self._X.ndim - len(input_domain_shape)
        self._X_batch_shape = tuple(self._X.shape[:batch_ndim])
        if tuple(self._X.shape) != self._X_batch_shape + input_domain_shape:
            raise ValueError(f"X of shape {tuple(self._X.shape)} has no trailing domain shape {input_domain_shape}")
        out = (
            input_codomain_shape + self._X_batch_shape
            if self.codomain_first
            else self._X_batch_shape + input_codomain_shape
        )
        super().__init__((input_domain_shape, input_codomain_shape), out)

    @property
    def X(self) -> torch.Tensor:
        return self._X

    @property
    def X_batch_shape(self):
        return self._X_batch_shape

    @property
    def X_batch_ndim(self) -> int:
        return len(self._X_batch_shape)

    def discretization(self) -> Discretization:
        pts = self._X.reshape((-1,) + self.input_domain_shape)
        return Discretization(pts, None, codomain_first=self.codomain_first)


class _EvaluationFunctional(_PointFunctional):
    """``f -> f(X)`` with output layout ``codomain_shape + X_batch_shape``."""

    def apply_to_function(self, f):
        vals = f(self._X)  # batch + codomain
        c_ndim = len(self.input_codomain_shape)
        if c_ndim:
            vals = torch.movedim(vals, tuple(range(vals.ndim - c_ndim, vals.ndim)), tuple(range(c_ndim)))
        return vals

    def __repr__(self):
        return f"Evaluation(X~{tuple(self._X.shape)})"


class DiracFunctional(_PointFunctional):
    """The same evaluations, batch-first output layout."""

    codomain_first = False

    def apply_to_function(self, f):
        return f(self._X)

    def __repr__(self):
        return f"Dirac(X~{tuple(self._X.shape)})"
