"""Multi-output priors, output selection and joint inference in the
PyTorch port (on the CPU, float64), against the JAX package.

Port of ``tests/test_multioutput.py`` (the CPU thermal case study's
machinery, ``experiments/cpu.py``): the block-diagonal Gram of an
``IndependentMultiOutputCovarianceFunction``; ``d^2 o SelectOutput``
reaching the component's closed form through ``StackCovarianceFunction``;
joint inference of ``(u, q_V, q_A)`` through the dense engine on operator,
boundary-flux and noisy point observations and the JAX test's aggregate
statistic (the Lebesgue integral of ``q_V`` plus the boundary fluxes),
with the posterior mean and std within 1e-8 of the JAX posterior's
(relative to their max) and the noiseless statistic interpolated to
1e-8; and the posterior covariance against a hand-rolled joint
conditioner (1e-12).
"""

import jax.numpy as jnp
import numpy as np
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.kernels import (
    IndependentMultiOutputCovarianceFunction,
    ScaledCovarianceFunction,
    StackCovarianceFunction,
)
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu_torch.ops.transforms.product import SumOfProductsKernel

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


def make_prior(pkg, width=1.0):
    f, k = pkg.functions, pkg.kernels
    return pkg.GaussianProcess(
        mean=f.StackedFunction(f.Constant((), 1.0), f.Constant((), 0.5), f.Constant((), -0.3)),
        cov=k.IndependentMultiOutputCovarianceFunction(
            3.0**2 * k.Matern((), nu=2.5, lengthscales=0.75 * width),
            0.9**2 * k.Matern((), nu=0.5, lengthscales=width),
            0.9**2 * k.Matern((), nu=0.5, lengthscales=width),
        ),
    )


def test_multioutput_kernel_matrix_block_structure():
    prior = make_prior(lgt)
    X = np.random.default_rng(5).uniform(0, 1, 4)
    G = prior.cov.matrix(torch.from_numpy(X)).numpy()
    assert G.shape == (12, 12)
    for i in range(3):
        for j in range(3):
            blk = G[4 * i:4 * (i + 1), 4 * j:4 * (j + 1)]
            if i != j:
                np.testing.assert_allclose(blk, 0.0)
            else:
                assert np.all(np.diagonal(blk) > 0)
    # The generic output-first flattening gives the same matrix.
    x = torch.from_numpy(X)
    generic = torch.movedim(prior.cov.pairwise(x, x), (2, 3), (0, 2)).reshape(12, 12).numpy()
    np.testing.assert_allclose(G, generic, rtol=0, atol=0)
    np.testing.assert_allclose(G, np.asarray(make_prior(jlgt).cov.matrix(jnp.asarray(X))), rtol=0, atol=1e-14)


def test_select_output_diffop_composition_uses_closed_forms():
    prior = make_prior(lgt)
    select_u = lgt.diffops.SelectOutput(input_shapes=((), (3,)), idx=0)
    L = lgt.diffops.Derivative(2) @ select_u
    k1 = apply_operator_to_kernel(L, prior.cov, argnum=1)
    assert isinstance(k1, StackCovarianceFunction)
    entry = k1.covfuncs[0]
    while isinstance(entry, ScaledCovarianceFunction):
        entry = entry.covfunc
    assert isinstance(entry, SumOfProductsKernel), type(entry)
    k2 = apply_operator_to_kernel(L, k1, argnum=0)
    x = torch.tensor(0.3, dtype=torch.float64)
    val = k2(x, x)
    assert torch.isfinite(val) and val > 0
    jprior = make_prior(jlgt)
    jL = jlgt.diffops.Derivative(2) @ jlgt.diffops.SelectOutput(input_shapes=((), (3,)), idx=0)
    jk2 = jlgt.ops.transforms.apply_operator_to_kernel(
        jL, jlgt.ops.transforms.apply_operator_to_kernel(jL, jprior.cov, argnum=1), argnum=0
    )
    np.testing.assert_allclose(val.item(), float(jk2(jnp.asarray(0.3), jnp.asarray(0.3))), rtol=1e-13)


def _joint(pkg, width=1.0, kappa=2.0):
    domain = pkg.domains.Interval(0.0, width)
    prior = make_prior(pkg, width)
    select = [pkg.diffops.SelectOutput(input_shapes=((), (3,)), idx=i) for i in range(3)]
    select_u, select_qV, select_qA = select
    pde = pkg.problems.PoissonEquation(domain, alpha=kappa)
    X_pde = np.asarray(domain.uniform_grid((7,)))
    post = prior.condition_on_observations(Y=np.zeros_like(X_pde), L=pde.diffop @ select_u - select_qV, X=X_pde)
    post = post.condition_on_observations(
        Y=np.asarray(0.0),
        L=(-kappa * pkg.diffops.DirectionalDerivative(np.asarray(1.0))) @ select_u - select_qA,
        X=np.asarray(0.0),
    )
    X_dts = np.asarray([0.2, 0.5, 0.8])
    post = post.condition_on_observations(
        Y=np.asarray([1.0, 1.2, 1.1]), L=select_u, X=X_dts, b=pkg.Normal(np.zeros(3), 0.05**2 * np.eye(3))
    )
    L_stat = 2.0 * pkg.functionals.LebesgueIntegral(input_domain=domain) @ select_qV + 2.0 * (
        select_qA.to_linfunctl(np.asarray(width)) + select_qA.to_linfunctl(np.asarray(0.0))
    )
    post = post.condition_on_observations(Y=np.asarray(0.0), L=L_stat)
    return post, L_stat, select_u, X_dts


def test_joint_multioutput_inference_end_to_end():
    post, L_stat, select_u, X_dts = _joint(lgt)
    grid = np.linspace(0, 1, 11)
    mean, std = post.mean(grid).numpy(), post.std(grid).numpy()
    assert mean.shape == (11, 3) and std.shape == (11, 3)
    assert np.all(np.isfinite(mean)) and np.all(np.isfinite(std))
    stat_rv = L_stat(post)
    np.testing.assert_allclose(float(stat_rv.mean), 0.0, atol=1e-8)
    assert float(stat_rv.std) < 1e-4
    u_post = select_u(post)
    np.testing.assert_allclose(u_post.mean(X_dts).numpy(), [1.0, 1.2, 1.1], atol=0.2)
    assert u_post.gram_cholesky is post.gram_cholesky
    jpost = _joint(jlgt)[0]
    jmean, jstd = np.asarray(jpost.mean(grid)), np.asarray(jpost.std(grid))
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-8 * np.abs(jmean).max())
    np.testing.assert_allclose(std, jstd, rtol=0, atol=1e-8 * jstd.max())


def test_multioutput_posterior_covariance_vs_naive():
    prior_cov = IndependentMultiOutputCovarianceFunction(
        lgt.kernels.Matern((), nu=2.5, lengthscales=0.7), lgt.kernels.ExpQuad((), lengthscales=0.4)
    )
    prior = lgt.GaussianProcess(lgt.functions.Zero((), (2,)), prior_cov)
    X = np.asarray([-0.5, 0.0, 0.5])
    Y = np.stack([np.sin(X), np.cos(X)], axis=-1)
    post = prior.condition_on_observations(Y, X=X)
    K = prior_cov.matrix(torch.from_numpy(X)).numpy()
    Kinv = np.linalg.inv(K)
    xq = np.asarray([0.2, -0.8])
    cov_eval = post.cov(torch.from_numpy(xq), torch.from_numpy(xq)).numpy()
    kqq = prior_cov(torch.from_numpy(xq), torch.from_numpy(xq)).numpy()
    for b, x in enumerate(xq):
        kx = prior_cov.matrix(torch.from_numpy(np.asarray([x])), torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(cov_eval[b], kqq[b] - kx @ Kinv @ kx.T, atol=1e-12)
