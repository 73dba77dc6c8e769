"""The port's symbolic layer against the JAX package's.

Both packages build the same kernels and operators; the port's
``kernel_term_specs`` must equal the JAX package's tuple for tuple and
float for float (the spec is what crosses into the kernels), and the
transformed kernels must take the same values on seeded points.  The
cases are those of ``tests/test_wendland_fast.py:28-117``,
``tests/test_diffops_closed_forms.py:49-124``, ``bench.py::_build_kernels``
and the Wendland experiment (``experiments/wendland_banded_tpu.py``).
"""

from fractions import Fraction
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as lgt
import linpde_gp_tpu_torch as lgtt
from linpde_gp_tpu.ops.kernels.wendland import wendland_polynomial as jax_wendland_polynomial
from linpde_gp_tpu.ops.pallas_gram import kernel_term_specs as jax_kernel_term_specs
from linpde_gp_tpu_torch.ops import diffops as port_diffops
from linpde_gp_tpu_torch.ops import kernels as port_kernels
from linpde_gp_tpu_torch.ops import transforms as port_transforms
from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
from linpde_gp_tpu_torch.ops.kernels.wendland import wendland_polynomial
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

JAX = SimpleNamespace(
    K=lgt.ops.kernels, D=lgt.ops.diffops, T=lgt.ops.transforms, GP=lgt.GaussianProcess, Zero=lgt.functions.Zero
)
PORT = SimpleNamespace(
    K=port_kernels, D=port_diffops, T=port_transforms, GP=lgtt.GaussianProcess, Zero=lgtt.models.functions.Zero
)


def _transform(ns, k, L0, L1):
    """``L0 k L1*`` as the JAX tests build it: the x1 slot first."""
    kk = k
    if L1 is not None:
        kk = ns.T.apply_operator_to_kernel(L1, kk, argnum=1)
    if L0 is not None:
        kk = ns.T.apply_operator_to_kernel(L0, kk, argnum=0)
    return kk


def _matern_pairs(nu):
    p = int(nu)

    def build(ns):
        k = ns.K.Matern((), nu=nu, lengthscales=0.8)
        return [
            _transform(ns, k, ns.D.Derivative(m) if m else None, ns.D.Derivative(n) if n else None)
            for m in range(p + 1)
            for n in range(p + 1)
            if m or n
        ]

    return build


def _wendland_pairs(k_smooth):
    def build(ns):
        k = ns.K.WendlandCovarianceFunction((), k=k_smooth, lengthscales=0.7)
        return [
            _transform(ns, k, ns.D.Derivative(m) if m else None, ns.D.Derivative(n) if n else None)
            for m in range(k_smooth + 1)
            for n in range(k_smooth + 1)
            if m or n
        ]

    return build


def _matern_diagonal(ns):
    out = []
    for nu in (1.5, 2.5):
        d1 = ns.D.Derivative(1)
        out.append(_transform(ns, ns.K.Matern((), nu=nu, lengthscales=1.0), d1, d1))
    return out


def _expquad_laplacian(ns):
    k = ns.K.ExpQuad((2,), lengthscales=[0.7, 1.3])
    L = ns.D.Laplacian((2,))
    D = ns.D.DirectionalDerivative([0.3, -1.2])
    return [_transform(ns, k, L, L), _transform(ns, k, None, L), _transform(ns, k, D, L), _transform(ns, k, D, D)]


def _tensor_product_heat(ns):
    k = ns.K.TensorProduct(
        ns.K.Matern((), nu=1.5, lengthscales=2.5), ns.K.Matern((), nu=2.5, lengthscales=2.0)
    )
    H = ns.D.HeatOperator((2,), alpha=0.1)
    return [_transform(ns, k, H, H), _transform(ns, k, None, H)]


def _scaled_laplacian(ns):
    k = 4.0 * ns.K.TensorProduct(
        ns.K.Matern((), nu=2.5, lengthscales=1.0), ns.K.Matern((), nu=2.5, lengthscales=1.0)
    )
    return [_transform(ns, k, None, ns.D.Laplacian((2,)))]


def _second_application(ns):
    k = ns.K.Matern((), nu=2.5, lengthscales=1.0)
    d1 = ns.D.Derivative(1)
    once = ns.T.apply_operator_to_kernel(d1, k, argnum=1)
    return [once, ns.T.apply_operator_to_kernel(d1, once, argnum=1),
            ns.T.apply_operator_to_kernel(ns.D.Derivative(2), k, argnum=1)]


def _bench_kernels(ns):
    """``bench.py::_build_kernels``: the heat benchmark's obs and cross kernels."""
    prior_cov = 1.0 * ns.K.TensorProduct(
        ns.K.Matern((), nu=1.5, lengthscales=2.5), ns.K.Matern((), nu=2.5, lengthscales=2.0)
    )
    H = ns.D.HeatOperator((2,), alpha=0.1)
    return [_transform(ns, prior_cov, H, H), _transform(ns, prior_cov, None, H)]


def _wendland_experiment(ns):
    return [2.0 * ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.05)]


def _wendland_base(ns):
    return [ns.K.WendlandCovarianceFunction((), k=1, lengthscales=0.15)]


def _wendland_tensor_laplacian(ns):
    k = ns.K.TensorProduct(
        ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.5),
        ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.4),
    )
    lap = ns.D.Laplacian((2,))
    return [_transform(ns, k, lap, lap)]


def _wendland_partial_2d(ns):
    k = ns.K.TensorProduct(
        ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.08),
        ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.3),
    )
    D = ns.D.PartialDerivative((1, 0))
    return [_transform(ns, k, D, D)]


def _wendland_heat_2d(ns):
    """The 2-D Wendland spec under the heat operator: 2 groups, 106
    coefficients, within the kernels' 128-coefficient cap."""
    k = ns.K.TensorProduct(
        ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.1),
        ns.K.WendlandCovarianceFunction((), k=2, lengthscales=0.3),
    )
    H = ns.D.HeatOperator((2,), alpha=0.1)
    return [_transform(ns, k, H, H), _transform(ns, k, None, H)]


CASES = {
    **{f"matern_pairs_nu{nu}": (_matern_pairs(nu), ()) for nu in (1.5, 2.5, 3.5, 4.5)},
    "matern_diagonal": (_matern_diagonal, ()),
    "expquad_laplacian": (_expquad_laplacian, (2,)),
    "tensor_product_heat": (_tensor_product_heat, (2,)),
    "scaled_laplacian": (_scaled_laplacian, (2,)),
    "second_application": (_second_application, ()),
    "bench_kernels": (_bench_kernels, (2,)),
    "wendland_experiment": (_wendland_experiment, ()),
    "wendland_base": (_wendland_base, ()),
    **{f"wendland_pairs_k{k}": (_wendland_pairs(k), ()) for k in (1, 2, 3)},
    "wendland_tensor_laplacian": (_wendland_tensor_laplacian, (2,)),
    "wendland_partial_2d": (_wendland_partial_2d, (2,)),
    "wendland_heat_2d": (_wendland_heat_2d, (2,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_term_specs_match_jax(case):
    build, _ = CASES[case]
    ours, theirs = build(PORT), build(JAX)
    assert len(ours) == len(theirs)
    for k_port, k_jax in zip(ours, theirs):
        spec = kernel_term_specs(k_port)
        assert spec is not None
        assert spec == jax_kernel_term_specs(k_jax)
        # Same Python types: the spec is a cache key of the kernels.
        assert hash(spec) == hash(jax_kernel_term_specs(k_jax))


@pytest.mark.parametrize("case", list(CASES))
def test_transformed_kernel_values_match_jax(case):
    """The port's kernels (closed forms in torch) against the JAX kernels
    on the same seeded float64 points, at 1e-12 of the largest value."""
    build, shape = CASES[case]
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1.0, 1.0, (7,) + shape)
    x1 = rng.uniform(-1.0, 1.0, (6,) + shape)
    for k_port, k_jax in zip(build(PORT), build(JAX)):
        want = np.asarray(k_jax(jnp.asarray(x0[:, None]), jnp.asarray(x1[None, :])))
        got = k_port(torch.from_numpy(x0[:, None]), torch.from_numpy(x1[None, :]))
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
        assert np.max(np.abs(got.numpy() - want)) <= 1e-12 * max(np.max(np.abs(want)), 1e-300)


def test_operators_compose_with_provenance():
    """A second operator on a transformed kernel composes the coefficient
    tables (``d o d = d^2``) instead of nesting kernels."""
    once, twice, direct = _second_application(PORT)
    assert isinstance(twice, port_transforms.SumOfProductsKernel)
    assert twice.base is once.base
    assert kernel_term_specs(twice) == kernel_term_specs(direct)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_wendland_polynomial_exact(d):
    for k in range(4):
        ours = wendland_polynomial(d, k).rational_coefficients
        assert all(isinstance(c, Fraction) for c in ours)
        assert ours == jax_wendland_polynomial(d, k).rational_coefficients


def test_matrix_matches_jax():
    """``CovarianceFunction.matrix`` on tensors, base kernels and the
    Wendland cut-off included."""
    X0 = np.random.default_rng(3).uniform(0.0, 1.0, 40)
    X1 = np.random.default_rng(4).uniform(0.0, 1.0, 56)
    for build in (_wendland_base, _wendland_experiment):
        (k_port,), (k_jax,) = build(PORT), build(JAX)
        got = k_port.matrix(torch.from_numpy(X0), torch.from_numpy(X1)).numpy()
        want = np.asarray(k_jax.matrix(jnp.asarray(X0), jnp.asarray(X1)))
        assert got.shape == (40, 56)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
        np.testing.assert_array_equal(got == 0.0, want == 0.0)


def test_no_silent_fallback():
    """Where the JAX package falls back to radial closed forms, autodiff or
    Bessel evaluation, the port takes the same route (the kernel classes
    match) and gives the JAX package's values off the diagonal; it never
    returns a different kernel in their place."""
    rng = np.random.default_rng(17)
    x0, x1 = rng.uniform(-1, 1, (5, 2)), rng.uniform(-1, 1, (5, 2))

    def iso(ns):  # isotropic: not a product
        return ns.T.apply_operator_to_kernel(ns.D.Laplacian((2,)), ns.K.Matern((2,), nu=1.5, lengthscales=1.0), argnum=1)

    def over(ns):  # 4th derivative of a C^2 kernel
        return _transform(ns, ns.K.Matern((), nu=1.5), ns.D.Derivative(2), ns.D.Derivative(2))

    def general(ns):
        return ns.K.Matern((), nu=1.2)

    for build, a, b in ((iso, x0, x1), (over, x0[:, 0], x1[:, 0]), (general, x0[:, 0], x1[:, 0])):
        kp, kj = build(PORT), build(JAX)
        assert type(kp).__name__ == type(kj).__name__, (type(kp), type(kj))
        got = kp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, np.asarray(kj(jnp.asarray(a), jnp.asarray(b))), rtol=1e-12, atol=1e-12)
    assert kernel_term_specs(port_kernels.Matern((), nu=1.2)) is None


def test_gaussian_process_shape_checks():
    k = port_kernels.Matern((), nu=1.5)
    gp = lgtt.GaussianProcess(PORT.Zero(()), k)
    assert gp.input_shape == () and gp.output_shape == ()
    assert torch.equal(gp.mean(torch.ones(5, dtype=torch.float64)), torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="input shapes"):
        lgtt.GaussianProcess(PORT.Zero((2,)), k)
