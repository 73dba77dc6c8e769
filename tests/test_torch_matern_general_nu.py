"""General (non-half-integer) ``nu`` Matérn in the PyTorch port (on the CPU,
float64, points from numpy seeds).

Port of ``tests/test_matern_general_nu.py``: ``kv`` against scipy
(1e-13 relative); the Bessel form against the scipy formula, the t = 0
limit included (1e-12); the Bessel path at a half-integer nu against the
closed form (1e-12); the autodiff fallback on d/dx0 (``kv``'s derivative
rule) against a central difference (1e-7, as the JAX test) and a GP
conditioned on its values interpolating them (1e-6); second derivatives
through ``torch.func.grad`` twice and ``torch.func.jvp`` twice against a
second difference (1e-5).  Beside those, the port against the JAX package:
the Gram and the autodiff kernel under d/dx0 and d^2/dx0 dx1 off the
diagonal (1e-12), and ``kv``'s values staying on its input's device and
dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as jax_apply
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.kernels import Matern, kv, matern_bessel
from linpde_gp_tpu_torch.ops.transforms import AutodiffTransformedKernel, apply_operator_to_kernel

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def test_kv_matches_scipy():
    x = np.geomspace(1e-3, 30.0, 64)
    for v in (0.3, 1.0, 2.2, 4.7):
        got = kv(v, _t(x))
        assert got.dtype == torch.float64 and got.device == torch.device("cpu")
        np.testing.assert_allclose(got.numpy(), sps.kv(v, x), rtol=1e-13)
    assert kv(1.2, _t(x).float()).dtype == torch.float32


@pytest.mark.parametrize("nu", [0.7, 2.2, 3.8])
def test_general_nu_matches_scipy_formula(nu):
    rng = np.random.default_rng(int(10 * nu))
    l = 0.6
    k = Matern(input_shape=(), nu=nu, lengthscales=l)
    x0, x1 = rng.uniform(-1, 1, 13), rng.uniform(-1, 1, 13)
    x1[3] = x0[3]  # the t == 0 limit
    t = np.sqrt(2 * nu) * np.abs(x0 - x1) / l
    ts = np.where(t > 0, t, 1.0)
    want = np.where(t > 0, 2 ** (1 - nu) / sps.gamma(nu) * ts**nu * sps.kv(nu, ts), 1.0)
    np.testing.assert_allclose(k(_t(x0), _t(x1)).numpy(), want, rtol=1e-12)


def test_bessel_path_agrees_with_half_integer_closed_form():
    rng = np.random.default_rng(7)
    l, nu = 0.9, 2.5
    k_closed = Matern(input_shape=(1,), nu=nu, lengthscales=l)
    x0, x1 = rng.uniform(-1, 1, (11, 1)), rng.uniform(-1, 1, (11, 1))
    t = np.sqrt(2 * nu) * np.abs(x0 - x1)[:, 0] / l
    np.testing.assert_allclose(matern_bessel(nu, _t(t)).numpy(), k_closed(_t(x0), _t(x1)).numpy(), rtol=1e-12)


def test_general_nu_diffop_fallback_and_conditioning():
    nu, l = 2.2, 0.8
    k = Matern(input_shape=(), nu=nu, lengthscales=l)
    kd = apply_operator_to_kernel(diffops.Derivative(order=1), k, argnum=0)
    assert isinstance(kd, AutodiffTransformedKernel)
    x0, x1 = np.array([0.3, -0.5, 0.75]), np.array([-0.1, 0.4, 0.2])
    h = 1e-6
    fd = (k(_t(x0 + h), _t(x1)).numpy() - k(_t(x0 - h), _t(x1)).numpy()) / (2 * h)
    np.testing.assert_allclose(kd(_t(x0), _t(x1)).numpy(), fd, atol=1e-7)
    # Conditioning on values of a known function: the posterior mean
    # interpolates the data.
    Xo = np.linspace(-1, 1, 8)
    post = lgt.GaussianProcess(lgt.functions.Zero(()), k).condition_on_observations(np.sin(2 * Xo), X=Xo)
    np.testing.assert_allclose(post.mean(Xo).numpy(), np.sin(2 * Xo), atol=1e-6)


def test_general_nu_gradient_is_second_order_differentiable():
    k = Matern(input_shape=(), nu=1.7, lengthscales=0.5)
    b = torch.tensor(0.25, dtype=torch.float64)
    a = torch.tensor(0.6, dtype=torch.float64)
    h = 1e-4
    fd2 = (float(k(a + h, b)) - 2 * float(k(a, b)) + float(k(a - h, b))) / h**2
    g2 = torch.func.grad(torch.func.grad(lambda z: k(z, b)))(a)
    assert abs(g2.item() - fd2) < 1e-5
    one = torch.ones((), dtype=torch.float64)

    def d1(z):
        return torch.func.jvp(lambda y: k(y, b), (z,), (one,))[1]

    j2 = torch.func.jvp(d1, (a,), (one,))[1]
    assert abs(j2.item() - fd2) < 1e-5


def test_general_nu_matches_jax():
    """The Gram and the autodiff kernels d/dx0 k and d/dx0 k d/dx1 of the
    Matérn nu = 1.2 off the diagonal, against the JAX package's."""
    rng = np.random.default_rng(11)
    x0, x1 = rng.uniform(-1, 1, (7, 1)), rng.uniform(-1, 1, (1, 6))
    k, jk = Matern((), nu=1.2, lengthscales=0.8), jlgt.kernels.Matern((), nu=1.2, lengthscales=0.8)
    D, jD = diffops.Derivative(1), jdiffops.Derivative(1)
    builds = [
        (k, jk),
        (apply_operator_to_kernel(D, k, argnum=0), jax_apply(jD, jk, argnum=0)),
        (apply_operator_to_kernel(D, apply_operator_to_kernel(D, k, argnum=1), argnum=0),
         jax_apply(jD, jax_apply(jD, jk, argnum=1), argnum=0)),
    ]
    for kk, jkk in builds:
        got = kk(_t(x0), _t(x1)).numpy()
        want = np.asarray(jkk(jnp.asarray(x0), jnp.asarray(x1)))
        assert got.shape == (7, 6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
