"""Gaussian random variables.

Port of ``linpde_gp_tpu/models/randvars.py``: ``Constant``, ``Normal``
(arithmetic, finite-dimensional conditioning and sampling) and
``asrandvar``.  Values are float64 tensors (``config.as_f64``: numpy
input lands on the default device).  ``Normal.sample`` takes a
``torch.Generator`` where the JAX package takes a key.  A 1-D covariance
is kept as a diagonal ``Covariance`` (its matrix formed only when asked
for), where the JAX package forms ``diag(cov)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import as_f64
from ..ops.linalg.chol import cho_solve, cholesky, solve_triangular
from ..ops.linalg.covariance import Covariance
from ..utils.shapes import as_shape


class RandomVariable:
    pass


class Constant(RandomVariable):
    """Deterministic value as a degenerate random variable."""

    def __init__(self, value):
        self._value = as_f64(value)

    @property
    def value(self):
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def mean(self):
        return self._value

    @property
    def cov(self) -> Covariance:
        return Covariance.from_diagonal(torch.zeros_like(self._value).reshape(-1), self.shape)

    @property
    def std(self):
        return torch.zeros_like(self._value)

    def __neg__(self):
        return Constant(-self._value)


class Normal(RandomVariable):
    """Multivariate normal with a ``Covariance``-view second moment.

    >>> import torch
    >>> rv = Normal(torch.zeros(2, dtype=torch.float64), 2.0 * torch.eye(2, dtype=torch.float64))
    >>> rv.shape
    (2,)
    >>> post = rv.condition_on_observations(
    ...     torch.tensor([1.0]), transform=torch.tensor([[1.0, 0.0]], dtype=torch.float64))
    >>> [round(float(m), 4) for m in post.mean]
    [1.0, 0.0]
    """

    def __init__(self, mean, cov):
        self._mean = as_f64(mean)
        if isinstance(cov, Covariance):
            self._cov = cov
        else:
            cov = as_f64(cov)
            if cov.ndim == 1:
                self._cov = Covariance.from_diagonal(cov, self.shape)
            else:
                self._cov = Covariance(cov, self.shape, self.shape)

    @property
    def shape(self):
        return tuple(self._mean.shape)

    @property
    def size(self) -> int:
        return int(self._mean.numel())

    @property
    def mean(self):
        return self._mean

    @property
    def cov(self) -> Covariance:
        return self._cov

    @property
    def cov_matrix(self) -> torch.Tensor:
        return self._cov.matrix

    @property
    def var(self):
        return self._cov.diagonal().reshape(self.shape)

    @property
    def std(self):
        # Posterior variances can round to tiny negatives.
        return torch.sqrt(torch.clamp(self.var, min=0.0))

    def sample(self, generator: torch.Generator | None = None, sample_shape=()):
        """Samples of shape ``sample_shape + shape``; ``generator`` seeds the
        standard normals (drawn on the mean's device)."""
        sample_shape = as_shape(sample_shape)
        chol = cholesky(self._cov.matrix)
        eps = torch.randn(
            sample_shape + (self.size,), generator=generator, dtype=self._mean.dtype, device=self._mean.device
        )
        flat = self._mean.reshape(-1) + eps @ chol.T
        return flat.reshape(sample_shape + self.shape)

    # -- arithmetic ------------------------------------------------------
    def __neg__(self):
        return Normal(-self._mean, self._cov)

    def __add__(self, other):
        if isinstance(other, Normal):
            return Normal(self._mean + other.mean.to(self._mean), self._cov + other.cov)
        if isinstance(other, Constant):
            return Normal(self._mean + other.value.to(self._mean), self._cov)
        return Normal(self._mean + torch.as_tensor(other).to(self._mean), self._cov)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            return Normal(scalar * self._mean, (scalar**2) * self._cov)
        return NotImplemented

    __rmul__ = __mul__

    def condition_on_observations(self, observations, transform=None, noise=None):
        """Finite-dimensional Gaussian conditioning of ``y = A x + b``:
        ``transform`` is ``A`` (``None``: the identity), ``noise`` an
        optional ``Normal`` / ``Constant`` ``b``."""
        mean = self._mean.reshape(-1)
        y = torch.as_tensor(observations).to(mean).reshape(-1)
        cov = self._cov.matrix
        if transform is None:
            A = torch.eye(mean.shape[0], dtype=mean.dtype, device=mean.device)
        else:
            from ..ops.linalg.linops import aslinop

            A = aslinop(transform).todense().to(mean)
        pred_mean = A @ mean
        crosscov = cov @ A.T
        gram = A @ crosscov
        if noise is not None:
            pred_mean = pred_mean + noise.mean.reshape(-1).to(mean)
            gram = noise.cov.add_to_(gram)
        chol = cholesky(gram)
        new_mean = mean + crosscov @ cho_solve(chol, y - pred_mean)
        half = solve_triangular(chol, crosscov.T)
        new_cov = cov - half.T @ half
        return Normal(new_mean.reshape(self.shape), Covariance(new_cov, self.shape, self.shape))


def asrandvar(obj) -> RandomVariable:
    if isinstance(obj, RandomVariable):
        return obj
    if isinstance(obj, (int, float, np.ndarray, torch.Tensor)) or np.isscalar(obj):
        return Constant(obj)
    raise TypeError(f"Cannot interpret {obj!r} as a RandomVariable.")
