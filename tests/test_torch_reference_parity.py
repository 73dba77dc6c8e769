"""Recorded-fixture parity of the port's dense conditioning engine.

Ports ``test_parity_poisson_1d``, ``_heat_1d`` and ``_poisson_2d`` of
``tests/test_reference_parity.py``: the port's
``GaussianProcess.condition_on_observations`` (float64 on the CPU,
through the kernels' plain versions) on the same configs, held to the
same ``tests/fixtures/reference_parity.json`` at the same ``TOL = 1e-6``,
and to the JAX posterior on the same inputs at the same tolerance.  Also
``test_parity_poisson_inverse_rhs``: the inverse right-hand-side problem,
whose priors have zero means; its ``f`` posterior takes the pushforward
``-Laplacian(u_post)`` as noise.  And ``test_parity_poisson_fem``: the
GP-FEM Poisson problem, conditioned on the boundary values and then on
the Galerkin observations ``A P[u] = b`` of the hat bases (weak form,
L2 projection, exact projection crosscov).
"""

import json
import os

import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

FIXTURES = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "reference_parity.json")))
NOISE = FIXTURES["noise"]
TOL = 1e-6


def _check(mean, std, ref_mean, ref_std):
    scale = max(np.max(np.abs(ref_mean)), 1.0)
    np.testing.assert_allclose(mean, ref_mean, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(std, ref_std, rtol=TOL, atol=TOL * scale)


def _poisson_1d(pkg, dops):
    def b(n):
        return pkg.Normal(np.zeros(n), NOISE * np.eye(n))

    prior = pkg.GaussianProcess(pkg.functions.Zero(()), 2.0**2 * pkg.kernels.ExpQuad((), lengthscales=1.0))
    X_pde = np.linspace(-0.8, 0.8, 8)
    post = prior.condition_on_observations(np.full(8, 2.0), X=X_pde, L=-1.0 * dops.Laplacian(()), b=b(8))
    return post.condition_on_observations(np.asarray([0.0, 1.0]), X=np.asarray([-1.0, 1.0]), b=b(2))


def _heat_1d(pkg, dops):
    def b(n):
        return pkg.Normal(np.zeros(n), NOISE * np.eye(n))

    prior = pkg.GaussianProcess(
        pkg.functions.Zero((2,)),
        1.0 * pkg.kernels.TensorProduct(
            pkg.kernels.Matern((), nu=1.5, lengthscales=2.5), pkg.kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )
    x_ic = np.linspace(-1.0 + 1e-6, 1.0 - 1e-6, 7)
    X_ic = np.stack([np.zeros(7), x_ic], -1)
    post = prior.condition_on_observations(np.sin(np.pi * 0.5 * (x_ic + 1.0)), X=X_ic, b=b(7))
    t_bc = np.linspace(0.0, 5.0, 6)
    for xb in (-1.0, 1.0):
        post = post.condition_on_observations(np.zeros(6), X=np.stack([t_bc, np.full(6, xb)], -1), b=b(6))
    tg = np.linspace(0.0, 5.0, 8)
    xg = np.linspace(-1.0, 1.0, 5)
    X_pde = np.stack(np.meshgrid(tg, xg, indexing="ij"), -1).reshape(-1, 2)
    return post.condition_on_observations(np.zeros(40), X=X_pde, L=dops.HeatOperator((2,), alpha=0.1), b=b(40))


def _poisson_2d(pkg, dops):
    def b(n):
        return pkg.Normal(np.zeros(n), NOISE * np.eye(n))

    prior = pkg.GaussianProcess(
        pkg.functions.Zero((2,)),
        1.0 * pkg.kernels.TensorProduct(
            pkg.kernels.Matern((), nu=2.5, lengthscales=1.0), pkg.kernels.Matern((), nu=2.5, lengthscales=1.0)
        ),
    )
    e = 1e-6
    s = np.linspace(-1.0 + e, 1.0 - e, 5)
    post = prior
    for edge in (
        np.stack([np.full(5, -1.0), s], -1),
        np.stack([np.full(5, 1.0), s], -1),
        np.stack([s, np.full(5, -1.0)], -1),
        np.stack([s, np.full(5, 1.0)], -1),
    ):
        post = post.condition_on_observations(np.zeros(5), X=edge, b=b(5))
    g = np.linspace(-1.0, 1.0, 5)
    X_pde = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return post.condition_on_observations(np.full(25, 2.0), X=X_pde, L=-1.0 * dops.Laplacian((2,)), b=b(25))


CASES = {"poisson_1d": _poisson_1d, "heat_1d": _heat_1d, "poisson_2d": _poisson_2d}


@pytest.mark.parametrize("name", list(CASES))
def test_parity(name):
    """The port against the recorded fixture and against the JAX posterior,
    both at TOL."""
    fx = FIXTURES[name]
    xq = np.asarray(fx["xq"])
    post = CASES[name](lgt, diffops)
    assert post.device == torch.device("cpu")
    mean, std = post.mean(xq), post.std(xq)
    assert mean.dtype == torch.float64 and mean.shape == np.asarray(fx["mean"]).shape
    _check(mean.numpy(), std.numpy(), np.asarray(fx["mean"]), np.asarray(fx["std"]))

    jpost = CASES[name](jlgt, jdiffops)
    _check(mean.numpy(), std.numpy(), np.asarray(jpost.mean(xq)), np.asarray(jpost.std(xq)))


def _poisson_inverse_rhs(pkg, dops, xp):
    """``test_reference_parity.py::test_parity_poisson_inverse_rhs``'s
    problem: ``(u_post, f_post)``; ``xp`` is the array module of ``pkg``."""
    mu_c, sig = 0.4, 0.3

    def b(n, var=NOISE):
        return pkg.Normal(np.zeros(n), var * np.eye(n))

    u_true = pkg.functions.LambdaFunction(lambda x: xp.exp(-0.5 / sig**2 * (x - mu_c) ** 2), ())
    u_prior = pkg.GaussianProcess(pkg.functions.Zero(()), 1.0 * pkg.kernels.ExpQuad((), lengthscales=0.5))
    f_prior = pkg.GaussianProcess(pkg.functions.Zero(()), 10.0**2 * pkg.kernels.ExpQuad((), lengthscales=0.25))
    D = -1.0 * dops.Laplacian(())
    X_bc = np.asarray([-1.0, 1.0])
    X_meas = np.linspace(-1.0, 1.0, 12)[1:-1]
    u_bc = u_prior.condition_on_observations(np.asarray(u_true(X_bc)), X=X_bc, b=b(2))
    u_bc_meas = u_bc.condition_on_observations(np.asarray(u_true(X_meas)), X=X_meas, b=b(10, 0.1**2))
    u_post = u_bc_meas.condition_on_observations(
        np.zeros(10), X=X_meas, L=D, b=(-1.0 * f_prior(X_meas)) + pkg.Normal(np.zeros(10), NOISE * np.eye(10))
    )
    X_pde = np.linspace(-1.0, 1.0, 10)
    Lu = D(u_bc_meas)(X_pde)
    f_post = f_prior.condition_on_observations(
        np.zeros(10), X=X_pde, b=(-1.0 * Lu) + pkg.Normal(np.zeros(10), NOISE * np.eye(10))
    )
    return u_post, f_post


def test_parity_poisson_inverse_rhs():
    """The port against the fixture's u and f posteriors and against the
    JAX posteriors, at TOL."""
    import jax.numpy as jnp

    fx = FIXTURES["poisson_inverse_rhs"]
    xq = np.asarray(fx["xq"])
    posts = _poisson_inverse_rhs(lgt, diffops, torch)
    jposts = _poisson_inverse_rhs(jlgt, jdiffops, jnp)
    for post, jpost, key in zip(posts, jposts, ("u", "f")):
        assert post.device == torch.device("cpu")
        mean, std = post.mean(xq).numpy(), post.std(xq).numpy()
        _check(mean, std, np.asarray(fx[f"{key}_mean"]), np.asarray(fx[f"{key}_std"]))
        _check(mean, std, np.asarray(jpost.mean(xq)), np.asarray(jpost.std(xq)))


def _poisson_fem(pkg, dops):
    """``test_reference_parity.py::test_parity_poisson_fem``'s problem: 5
    elements, ``-Laplacian`` weak form against the L2-projected trial basis."""
    def b(n):
        return pkg.Normal(np.zeros(n), NOISE * np.eye(n))

    grid = np.linspace(-1.0, 1.0, 7)
    trial = pkg.functions.UnivariateLinearInterpolationBasis(grid, zero_boundary=False)
    test = pkg.functions.UnivariateLinearInterpolationBasis(grid, zero_boundary=True)
    galerkin = (-1.0 * dops.Laplacian(())).weak_form(test)(trial)
    rhs = np.asarray(test.l2_projection(normalized=False)(pkg.functions.Constant((), 2.0)))
    prior = pkg.GaussianProcess(pkg.functions.Zero(()), 1.0 * pkg.kernels.Matern((), nu=1.5, lengthscales=1.0))
    post = prior.condition_on_observations(np.asarray([0.0, 1.0]), X=np.asarray([-1.0, 1.0]), b=b(2))
    return post.condition_on_observations(rhs, L=galerkin @ trial.l2_projection(), b=b(len(rhs)))


def test_parity_poisson_fem():
    """The port against the fixture and against the JAX posterior, at TOL."""
    fx = FIXTURES["poisson_fem"]
    xq = np.asarray(fx["xq"])
    post = _poisson_fem(lgt, diffops)
    assert post.device == torch.device("cpu")
    mean, std = post.mean(xq).numpy(), post.std(xq).numpy()
    _check(mean, std, np.asarray(fx["mean"]), np.asarray(fx["std"]))
    jpost = _poisson_fem(jlgt, jdiffops)
    _check(mean, std, np.asarray(jpost.mean(xq)), np.asarray(jpost.std(xq)))
