"""Functional application dispatch (the ``L(.)`` rule table).

Port of ``linpde_gp_tpu/ops/transforms/functionals.py``
(``apply_functional``, ``:36``): the routes for covariance functions,
process-vector cross-covariances, GPs and their posteriors, deterministic
processes and functions (``Zero``, scaled, sum and composite functionals
symbolically; a composite's operator reaches any function through
``dispatch.apply_operator_to_function``).  A Laplacian weak form applied
to a trial hat basis gives its stiffness matrix, and a Lebesgue integral of
a constant, or on an interval of a polynomial or a piecewise polynomial, is
integrated exactly.
"""

from __future__ import annotations

import torch

from ...config import resolve_device
from ...models.domains import Interval
from ...models.functions.base import Function, Zero
from ...models.functions.basic import Constant, Piecewise
from ...models.functions.fem import UnivariateLinearInterpolationBasis
from ...models.functions.polynomial import Polynomial
from ..crosscov.base import KernelFunctionalCrossCov, ProcessVectorCrossCovariance, apply_functional_to_crosscov
from ..functionals.base import (
    CompositeLinearFunctional,
    LinearFunctional,
    ScaledLinearFunctional,
    SumLinearFunctional,
)
from ..functionals.integrals import LebesgueIntegral
from ..functionals.weak_forms import WeakForm_Laplacian_UnivariateInterpolationBasis
from ..kernels.base import CovarianceFunction


def apply_functional(functional: LinearFunctional, obj, /, **kwargs):
    from ...models.gp import ConditionalGaussianProcess, GaussianProcess
    from ...models.randprocs import DeterministicProcess
    from ...models.randvars import Constant as ConstantRV
    from ...models.randvars import Normal
    from ..linalg.covariance import Covariance

    # A weak form applied to a trial basis: the stiffness matrix.
    if isinstance(functional, WeakForm_Laplacian_UnivariateInterpolationBasis) and isinstance(
        obj, UnivariateLinearInterpolationBasis
    ):
        return functional.stiffness_matrix(obj)

    if isinstance(obj, CovarianceFunction):
        return KernelFunctionalCrossCov(obj, functional, kwargs.get("argnum", 1))

    if isinstance(obj, ProcessVectorCrossCovariance):
        return apply_functional_to_crosscov(functional, obj)

    if isinstance(obj, ConditionalGaussianProcess):
        # The posterior's functional marginal through its cached factor and
        # weights, and its solver (refined or plain Cholesky).
        block = apply_functional_to_crosscov(functional, obj.kLas).matrix
        prior_rv = apply_functional(functional, obj.prior)
        mean = prior_rv.mean.reshape(-1).to(block) + block @ obj.representer_weights
        cov = prior_rv.cov.matrix.to(block) - block @ obj.solve_gram(block.T)
        return Normal(
            mean.reshape(functional.output_shape),
            Covariance(cov, functional.output_shape, functional.output_shape),
        )

    if isinstance(obj, GaussianProcess):
        kLa = apply_functional(functional, obj.cov, argnum=1)
        gram = apply_functional_to_crosscov(functional, kLa)
        mean = functional.apply_to_function(obj.mean)
        return Normal(mean, gram)

    if isinstance(obj, DeterministicProcess):
        return ConstantRV(apply_functional(functional, obj.as_fn()))

    if isinstance(obj, Function):
        return _apply_to_function_symbolic(functional, obj)

    raise TypeError(f"Cannot apply functional {functional!r} to {type(obj).__name__}.")


def _apply_to_function_symbolic(functional: LinearFunctional, f: Function):
    """Function application with the exact shortcuts: zero functions, the
    weak form on a trial basis, scaled, sum and composite functionals, and
    exact Lebesgue integrals."""
    if isinstance(f, Zero):
        return torch.zeros(functional.output_shape, dtype=torch.float64, device=resolve_device())
    if isinstance(functional, WeakForm_Laplacian_UnivariateInterpolationBasis) and isinstance(
        f, UnivariateLinearInterpolationBasis
    ):
        return functional.stiffness_matrix(f)
    if isinstance(functional, ScaledLinearFunctional):
        return functional.scalar * _apply_to_function_symbolic(functional.linfunctl, f)
    if isinstance(functional, SumLinearFunctional):
        out = None
        for s in functional.summands:
            term = _apply_to_function_symbolic(s, f)
            out = term if out is None else out + term
        return out
    if isinstance(functional, CompositeLinearFunctional):
        from .dispatch import apply_operator_to_function

        g = f
        if functional.linfuncop is not None:
            g = apply_operator_to_function(functional.linfuncop, g)
        vals = _apply_to_function_symbolic(functional.linfunctl, g)
        if functional.linop is not None:
            vals = functional.linop @ vals.reshape(-1)
        return vals.reshape(functional.output_shape)
    if isinstance(functional, LebesgueIntegral):
        exact = _exact_lebesgue_integral(functional, f)
        if exact is not None:
            return exact
    return functional.apply_to_function(f)


def _exact_lebesgue_integral(functional: LebesgueIntegral, f: Function):
    """The exact integral of a constant on any domain, and on an interval of
    a polynomial or a piecewise polynomial; else ``None``.  A float64 tensor
    on the default device."""
    domain = functional.domain

    def value(v):
        return torch.as_tensor(v, dtype=torch.float64).to(resolve_device())

    def at(x):
        return torch.tensor(float(x), dtype=torch.float64)

    if isinstance(f, Constant):
        return value(f.value * domain.volume)
    if isinstance(domain, Interval):
        a, b = float(domain[0]), float(domain[1])
        if isinstance(f, Polynomial):
            anti = f.integrate()
            return value(anti(at(b)) - anti(at(a)))
        if isinstance(f, Piecewise) and all(isinstance(p, Polynomial) for p in f.pieces):
            total = 0.0
            for piece, lo, hi in zip(f.pieces, f.xs[:-1], f.xs[1:]):
                lo_c, hi_c = max(lo, a), min(hi, b)
                if hi_c <= lo_c:
                    continue
                anti = piece.integrate()
                total = total + (anti(at(hi_c)) - anti(at(lo_c)))
            return value(total)
    return None
