"""The cases of ``tests/test_kernels.py`` that no other port test covers,
on the port's kernels against the JAX package's at 1e-12 (and against
the hand-computed formulas, as there): the ExpQuad value, the
half-integer Matérn closed forms, nu = inf against ExpQuad, the tensor
product against the product of its factors, ``uniform_grid``'s
``TensorProductGrid``, pairwise flattening of ``matrix``, kernel
arithmetic and the zero kernel.  (The Kronecker and sum-of-Kronecker grid
operators are ``test_torch_grid.py``'s.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as tlgt
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
config.set(device="cpu")

RTOL = 1e-12


def _both(build, *args):
    """``(port, jax)`` values of ``build(pkg)(*args)`` as numpy, the port
    on float64 tensors."""
    got = build(tlgt)(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args))
    want = build(jlgt)(*(jnp.asarray(a) for a in args))
    return np.asarray(got.numpy(), np.float64), np.asarray(want, np.float64)


def test_expquad_value():
    got, want = _both(lambda p: p.kernels.ExpQuad((), lengthscales=2.0), 0.0, 0.7)
    np.testing.assert_allclose(got, np.exp(-0.5 * (0.7 / 2.0) ** 2), rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize(
    "nu,formula",
    [
        (0.5, lambda t: np.exp(-t)),
        (1.5, lambda t: (1 + t) * np.exp(-t)),
        (2.5, lambda t: (1 + t + t**2 / 3) * np.exp(-t)),
        (3.5, lambda t: (1 + t + 2 * t**2 / 5 + t**3 / 15) * np.exp(-t)),
    ],
)
def test_matern_closed_form_values(nu, formula):
    """Rasmussen-Williams half-integer Matérn formulas."""
    ls = 0.8
    d = np.abs(np.random.default_rng(21).uniform(-2, 2, 7))
    got, want = _both(lambda p: p.kernels.Matern((), nu=nu, lengthscales=ls), np.zeros(7), d)
    np.testing.assert_allclose(got, formula(np.sqrt(2 * nu) * d / ls), rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_matern_inf_equals_expquad():
    rng = np.random.default_rng(3)
    x0, x1 = rng.uniform(-1, 1, (5, 2)), rng.uniform(-1, 1, (5, 2))
    got, want = _both(lambda p: p.kernels.Matern((2,), nu=np.inf, lengthscales=0.9), x0, x1)
    ref, _ = _both(lambda p: p.kernels.ExpQuad((2,), lengthscales=0.9), x0, x1)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_tensor_product_equals_product():
    rng = np.random.default_rng(4)
    x0, x1 = rng.uniform(-1, 1, (6, 2)), rng.uniform(-1, 1, (6, 2))

    def kt(p):
        return p.kernels.TensorProduct(p.kernels.Matern((), nu=1.5, lengthscales=0.5),
                                       p.kernels.ExpQuad((), lengthscales=1.1))

    got, want = _both(kt, x0, x1)
    ka, _ = _both(lambda p: p.kernels.Matern((), nu=1.5, lengthscales=0.5), x0[:, 0], x1[:, 0])
    kb, _ = _both(lambda p: p.kernels.ExpQuad((), lengthscales=1.1), x0[:, 1], x1[:, 1])
    np.testing.assert_allclose(got, ka * kb, rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_uniform_grid_returns_tensor_product_grid():
    grid = tlgt.domains.Box([[0.0, 1.0], [0.0, 2.0]]).uniform_grid((4, 5))
    want = jlgt.domains.Box([[0.0, 1.0], [0.0, 2.0]]).uniform_grid((4, 5))
    assert isinstance(grid, tlgt.kernels.TensorProductGrid)
    assert np.asarray(grid).shape == (4, 5, 2) and len(grid.factors) == 2
    np.testing.assert_array_equal(np.asarray(grid), np.asarray(want))


def test_gram_matrix_matches_pairwise_flattening():
    rng = np.random.default_rng(5)
    X0, X1 = rng.uniform(-1, 1, 5), rng.uniform(-1, 1, 3)
    k = tlgt.kernels.Matern((), nu=2.5, lengthscales=0.7)
    G = k.matrix(torch.from_numpy(X0), torch.from_numpy(X1)).numpy()
    pairs = np.array([[float(k(torch.tensor(a), torch.tensor(b))) for b in X1] for a in X0])
    np.testing.assert_allclose(G, pairs, rtol=RTOL)
    want = np.asarray(jlgt.kernels.Matern((), nu=2.5, lengthscales=0.7).matrix(jnp.asarray(X0), jnp.asarray(X1)))
    np.testing.assert_allclose(G, want, rtol=RTOL)


def test_kernel_arithmetic():
    def k(p):
        return 2.0 * p.kernels.ExpQuad((), lengthscales=1.0) + p.kernels.Matern((), nu=1.5, lengthscales=1.0)

    got, want = _both(k, 0.2, -0.4)
    a, _ = _both(lambda p: p.kernels.ExpQuad((), lengthscales=1.0), 0.2, -0.4)
    b, _ = _both(lambda p: p.kernels.Matern((), nu=1.5, lengthscales=1.0), 0.2, -0.4)
    np.testing.assert_allclose(got, 2.0 * a + b, rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_zero_kernel():
    x = np.random.default_rng(6).uniform(-1, 1, 4)
    got, want = _both(lambda p: p.kernels.ZeroCovarianceFunction(()), x, x)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(got, want)
