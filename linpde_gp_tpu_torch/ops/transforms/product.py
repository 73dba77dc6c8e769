r"""Operator-transformed kernels by tensor-product distribution.

Port of ``linpde_gp_tpu/ops/transforms/product.py``: for a product
kernel ``k(x0, x1) = prod_i k_i(x0_i, x1_i)`` and constant-coefficient
diffops ``L0 = sum_a c0_a d^{alpha_a}``, ``L1 = sum_b c1_b d^{beta_b}``,

    (L0 k L1*)(x0, x1)
      = sum_{a,b} c0_a c1_b prod_i d^{alpha_a[i]}_{x0_i} d^{beta_b[i]}_{x1_i} k_i,

a sum of products of closed-form 1-D factors (``univariate.py``).  On
tensor-product grids its Gram is a sum of Kronecker products of the 1-D
factor Grams (``CovarianceFunction.linop``).
"""

from __future__ import annotations

import numpy as np

from ..kernels.base import CovarianceFunction
from ..kernels.stationary import ExpQuad, Matern
from ..kernels.tensor_product import TensorProduct
from ..kernels.wendland import WendlandCovarianceFunction
from .univariate import expquad_factor, matern_factor, wendland_factor


def product_factor_specs(kernel: CovarianceFunction):
    """Per-dimension 1-D factor constructors ``[fn(m, n) ->
    UnivariateFactor]``, or ``None`` if the kernel is not a product."""
    if isinstance(kernel, ExpQuad):
        ls = np.broadcast_to(kernel.lengthscales, kernel.input_shape).reshape(-1)
        if ls.size == 0:
            ls = np.asarray([float(kernel.lengthscales)])
        return [(lambda m, n, l=float(l): expquad_factor(l, m, n)) for l in np.atleast_1d(ls)]  # noqa: E741
    if isinstance(kernel, Matern):
        if kernel.input_size > 1:
            return None  # isotropic multivariate Matérn is not a product
        if kernel.nu != np.inf and not kernel.is_half_integer:
            return None  # general nu: no closed form
        l = float(np.ravel(kernel.lengthscales)[0]) if kernel.lengthscales.size else float(kernel.lengthscales)  # noqa: E741
        nu = kernel.nu
        return [lambda m, n, l=l, nu=nu: matern_factor(nu, l, m, n)]
    if isinstance(kernel, WendlandCovarianceFunction):
        if kernel.input_size > 1:
            return None  # isotropic multivariate Wendland is radial
        l = (  # noqa: E741
            float(np.ravel(kernel.lengthscales)[0]) if np.ndim(kernel.lengthscales) else float(kernel.lengthscales)
        )
        dd, kk = kernel.d, kernel.k
        return [lambda m, n, l=l, dd=dd, kk=kk: wendland_factor(dd, kk, l, m, n)]
    if isinstance(kernel, TensorProduct):
        specs = []
        for f in kernel.factors:
            sub = product_factor_specs(f)
            if sub is None or len(sub) != 1:
                return None
            specs.append(sub[0])
        return specs
    return None


class SumOfProductsKernel(CovarianceFunction):
    """``k(x0, x1) = sum_t coeff_t prod_i f_{t,i}(x0_i, x1_i)``.

    Keeps the provenance ``(base, coeffs0, coeffs1)`` so that a further
    operator composes symbolically with the ones already applied.
    """

    def __init__(self, input_shape, terms, base: CovarianceFunction | None = None, coeffs0=None, coeffs1=None):
        super().__init__(input_shape)
        self._terms = [(float(c), tuple(factors)) for c, factors in terms if c != 0.0]
        if not self._terms:
            self._terms = [(0.0, tuple(terms[0][1]))] if terms else []
        self.base = base
        self.coeffs0 = coeffs0
        self.coeffs1 = coeffs1

    @property
    def terms(self):
        return self._terms

    def _evaluate(self, x0, x1):
        scalar_input = self.input_ndim == 0
        cache: dict = {}  # factor values shared across terms

        def factor_val(i, f):
            key = (i, id(f))
            if key not in cache:
                a0 = x0 if scalar_input else x0[..., i]
                a1 = x1 if scalar_input else x1[..., i]
                cache[key] = f(a0, a1)
            return cache[key]

        out = None
        for coeff, factors in self._terms:
            term = None
            for i, f in enumerate(factors):
                val = factor_val(i, f)
                term = val if term is None else term * val
            term = coeff * term
            out = term if out is None else out + term
        return out


def transform_product_kernel(kernel: CovarianceFunction, coeffs0, coeffs1) -> SumOfProductsKernel | None:
    """The closed-form ``L0 k L1*`` of a product-decomposable kernel
    (``coeffs0`` / ``coeffs1``: scalar-codomain
    ``PartialDerivativeCoefficients``, or ``None`` for the identity), or
    ``None`` where there is none."""
    specs = product_factor_specs(kernel)
    if specs is None:
        return None

    def term_list(coeffs):
        if coeffs is None:
            return [((), 1.0, None)]
        out = []
        for codomain_idx, multi_index, coeff in coeffs.items_flat():
            if codomain_idx != ():
                return None  # multi-output operators
            out.append((codomain_idx, coeff, multi_index.factorize_dimwise()))
        return out

    t0 = term_list(coeffs0)
    t1 = term_list(coeffs1)
    if t0 is None or t1 is None:
        return None

    ndims = len(specs)
    factor_cache: dict = {}

    def factor(i, m, n):
        key = (i, m, n)
        if key not in factor_cache:
            factor_cache[key] = specs[i](m, n)
        return factor_cache[key]

    terms = []
    for _, c0, alpha in t0:
        for _, c1, beta in t1:
            orders0 = alpha if alpha is not None else (0,) * ndims
            orders1 = beta if beta is not None else (0,) * ndims
            if len(orders0) != ndims or len(orders1) != ndims:
                return None
            try:
                factors = [factor(i, orders0[i], orders1[i]) for i in range(ndims)]
            except ValueError:
                return None  # derivative order exceeds the kernel's smoothness
            terms.append((c0 * c1, factors))

    return SumOfProductsKernel(kernel.input_shape, terms, base=kernel, coeffs0=coeffs0, coeffs1=coeffs1)
