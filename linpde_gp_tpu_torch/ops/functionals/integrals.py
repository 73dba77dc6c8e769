"""Lebesgue integral functionals by fixed Gauss-Legendre panels.

Port of ``linpde_gp_tpu/ops/functionals/integrals.py``: composite
Gauss-Legendre of ``config.quadrature_order`` nodes on each of
``config.quadrature_panels`` panels per interval, a tensor-product rule on
boxes.  The nodes and weights are computed on the host in float64 and
held on ``config.resolve_device()``; the exact rules (constants,
polynomials, half-integer Matérn kernels on intervals) short-circuit in
``ops/transforms/functionals.py`` and ``ops/transforms/integrals_exact.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import config, resolve_device
from ...models.domains import Box, CartesianProduct, Domain, Interval, asdomain
from .base import Discretization, LinearFunctional


@functools.lru_cache(maxsize=None)
def _gauss_legendre(order: int):
    nodes, weights = np.polynomial.legendre.leggauss(order)
    return nodes, weights


def interval_quadrature(a: float, b: float, order: int, panels: int):
    """Composite Gauss-Legendre nodes and weights on ``[a, b]`` (numpy)."""
    nodes, weights = _gauss_legendre(order)
    edges = np.linspace(a, b, panels + 1)
    all_nodes, all_weights = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        all_nodes.append(mid + half * nodes)
        all_weights.append(half * weights)
    return np.concatenate(all_nodes), np.concatenate(all_weights)


class LebesgueIntegral(LinearFunctional):
    r"""``f -> \int_domain f(x) dx``.

    Applied to a :class:`GaussianProcess` it gives the Gaussian pushforward;
    applied to a function it integrates by the fixed Gauss-Legendre panels
    (the exact rules short-circuit).

    Examples
    --------
    >>> import linpde_gp_tpu_torch as lgt
    >>> lgt.config.set(device="cpu")
    >>> I = LebesgueIntegral(lgt.domains.asdomain([0.0, 1.0]))
    >>> round(float(I(lgt.functions.Polynomial([0.0, 2.0]))), 6)
    1.0
    >>> gp = lgt.GaussianProcess(lgt.functions.Zero(()), lgt.kernels.Matern((), nu=1.5))
    >>> round(float(I(gp).std), 4)
    0.9314
    """

    def __init__(self, domain=None, codomain_shape=(), *, input_domain=None) -> None:
        if domain is None:
            domain = input_domain  # the reference's keyword
        self._domain: Domain = asdomain(domain)
        super().__init__((self._domain.shape, codomain_shape), codomain_shape)
        if self.input_codomain_shape != ():
            raise NotImplementedError("Only scalar-codomain integrals.")

    @property
    def domain(self) -> Domain:
        return self._domain

    def discretization(self) -> Discretization:
        order, panels = config.quadrature_order, config.quadrature_panels
        if isinstance(self._domain, Interval):
            nodes, weights = interval_quadrature(float(self._domain[0]), float(self._domain[1]), order, panels)
            return _on_device(nodes, weights[None, :])
        if isinstance(self._domain, (Box, CartesianProduct)):
            factor_nodes, factor_weights = [], []
            for factor in self._domain.factors:
                if isinstance(factor, Interval):
                    n, w = interval_quadrature(float(factor[0]), float(factor[1]), order, panels)
                else:  # a Point factor has measure zero: the integral is zero
                    n, w = np.asarray([float(np.asarray(factor))]), np.asarray([0.0])
                factor_nodes.append(n)
                factor_weights.append(w)
            mesh = np.stack(np.meshgrid(*factor_nodes, indexing="ij"), axis=-1).reshape(-1, len(factor_nodes))
            wmesh = np.ones(())
            for w in factor_weights:
                wmesh = np.multiply.outer(wmesh, w)
            return _on_device(mesh, wmesh.reshape(1, -1))
        raise NotImplementedError(f"No quadrature for domain type {type(self._domain).__name__}.")

    def __repr__(self):
        return f"LebesgueIntegral({self._domain!r})"


def _on_device(points, weights) -> Discretization:
    device = resolve_device()
    return Discretization(
        torch.tensor(points, dtype=torch.float64, device=device),
        torch.tensor(weights, dtype=torch.float64, device=device),
    )
