"""Isotropic multivariate half-integer Matérn under differential operators
in the PyTorch port (on the CPU, float64, points from numpy seeds).

Port of ``tests/test_radial_matern.py``: the radial closed forms
(``RadialMaternDerivativeKernel``) for directional derivatives, weighted
Laplacians and Laplacians on either slot, nu in {1.5, 2.5, 3.5} and d in
{2, 3}, against the port's own autodiff oracle off the diagonal (1e-10,
the JAX test's bound) and against the JAX package's radial kernel
(1e-12 relative to max |k|, the diagonal included: exact there); the
diagonal's exact value; a positive-definite Gram; and the 2-D Poisson
problem with an isotropic prior through the dense engine, whose PDE
residual must be below 1e-7, as in the JAX test, and whose posterior
mean must match the JAX posterior's within 1e-8 of max |mean|.  Beside
those, ``IterativeGPRegressor`` on that radial kernel (no sum-of-products
spec: the dense-Gram route) against the JAX regressor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as jax_apply
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.transforms import (
    AutodiffTransformedKernel,
    apply_operator_to_kernel,
    as_coefficients,
)
from linpde_gp_tpu_torch.ops.transforms.radial import RadialMaternDerivativeKernel

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


def _ops(d, dops, seed):
    rng = np.random.default_rng(seed)
    return {
        "DD": (dops.DirectionalDerivative(rng.uniform(-1, 1, (d,))), 1),
        "WL": (dops.WeightedLaplacian(rng.uniform(0.5, 2, (d,))), 2),
        "Lap": (dops.Laplacian((d,)), 2),
    }


def _transform(k, L0, L1, apply):
    kk = k
    if L1 is not None:
        kk = apply(L1, kk, argnum=1)
    if L0 is not None:
        kk = apply(L0, kk, argnum=0)
    return kk


@pytest.mark.parametrize("nu", [1.5, 2.5, 3.5])
@pytest.mark.parametrize("d", [2, 3])
def test_radial_matern_matrix(nu, d):
    shape = (d,)
    rng = np.random.default_rng(int(10 * nu) + d)
    ls = rng.uniform(0.5, 1.5, shape)
    k, jk = lgt.kernels.Matern(shape, nu=nu, lengthscales=ls), jlgt.kernels.Matern(shape, nu=nu, lengthscales=ls)
    ops, jops = _ops(d, diffops, d), _ops(d, jdiffops, d)
    cases = [("id", None, None, 0)] + [(n, op, jops[n][0], o) for n, (op, o) in ops.items()]
    x0 = rng.uniform(-1, 1, (6,) + shape)
    x1 = rng.uniform(-1, 1, (5,) + shape)
    pairs = (torch.from_numpy(x0[:, None]), torch.from_numpy(x1[None, :]))
    diag = torch.from_numpy(np.concatenate([x0, x0[:2]]))
    for name0, L0, J0, o0 in cases:
        for name1, L1, J1, o1 in cases:
            if L0 is None and L1 is None or o0 + o1 > 2 * int(nu):
                continue
            kk = _transform(k, L0, L1, apply_operator_to_kernel)
            assert isinstance(kk, RadialMaternDerivativeKernel), (name0, name1, type(kk))
            oracle = AutodiffTransformedKernel(
                k, None if L0 is None else as_coefficients(L0), None if L1 is None else as_coefficients(L1)
            )
            got = kk(*pairs).numpy()
            np.testing.assert_allclose(got, oracle(*pairs).numpy(), atol=1e-10, err_msg=f"{name0}/{name1}")
            jkk = _transform(jk, J0, J1, jax_apply)
            want = np.asarray(jkk(jnp.asarray(x0[:, None]), jnp.asarray(x1[None, :])))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max(), err_msg=f"{name0}/{name1}")
            d_got = kk(diag, diag).numpy()
            d_want = np.asarray(jkk(jnp.asarray(diag.numpy()), jnp.asarray(diag.numpy())))
            assert np.all(np.isfinite(d_got)), (name0, name1)
            np.testing.assert_allclose(d_got, d_want, rtol=0, atol=1e-12 * max(np.abs(d_want).max(), 1.0))


def test_radial_diagonal_exact_value():
    """Var[d_0 u] for the isotropic nu = 2.5 Matérn at unit lengthscale is
    2 nu / 3, as in 1-D."""
    k2 = lgt.kernels.Matern((2,), nu=2.5, lengthscales=1.0)
    D = diffops.DirectionalDerivative(np.array([1.0, 0.0]))
    kk = apply_operator_to_kernel(D, apply_operator_to_kernel(D, k2, argnum=1), argnum=0)
    val = float(kk(torch.zeros(2, dtype=torch.float64), torch.zeros(2, dtype=torch.float64)))
    np.testing.assert_allclose(val, (2 * 2.5) / 3.0, rtol=1e-12)


def test_radial_gram_is_positive_definite():
    k = lgt.kernels.Matern((2,), nu=2.5, lengthscales=0.8)
    L = diffops.Laplacian((2,))
    kk = apply_operator_to_kernel(L, apply_operator_to_kernel(L, k, argnum=1), argnum=0)
    X = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (25, 2)))
    G = kk.matrix(X).numpy()
    np.testing.assert_allclose(G, G.T, atol=1e-10)
    evals = np.linalg.eigvalsh(G)
    assert evals.min() > -1e-8 * evals.max()


def _poisson_2d(pkg):
    """``test_radial_matern.py::test_isotropic_matern_poisson_2d_end_to_end``'s
    problem: -Laplacian u = 2 on [-1, 1]^2, u = 0 on the boundary."""
    bvp = pkg.problems.PoissonEquationDirichletProblem(
        domain=pkg.domains.Box([[-1.0, 1.0], [-1.0, 1.0]]),
        rhs=pkg.functions.Constant((2,), 2.0),
        boundary_values=pkg.functions.Constant((2,), 0.0),
    )
    prior = pkg.GaussianProcess(pkg.functions.Zero((2,)), 2.0**2 * pkg.kernels.Matern((2,), nu=2.5, lengthscales=1.0))
    post = prior
    for bc in bvp.boundary_conditions:
        X_bc = np.asarray(bc.boundary.uniform_grid(6, inset=1e-6)).reshape(-1, 2)
        post = post.condition_on_observations(np.zeros(X_bc.shape[0]), X=X_bc)
    X_pde = np.asarray(bvp.domain.uniform_grid((7, 7))).reshape(-1, 2)
    post = post.condition_on_observations(np.full(49, 2.0), X=X_pde, L=bvp.pde.diffop)
    return bvp, post, X_pde


def test_isotropic_matern_poisson_2d_end_to_end():
    """The radial Gram on the dense engine's path."""
    bvp, post, X_pde = _poisson_2d(lgt)
    resid = bvp.pde.diffop(post).mean(X_pde).numpy() - 2.0
    assert np.max(np.abs(resid)) < 1e-7, np.max(np.abs(resid))
    _, jpost, _ = _poisson_2d(jlgt)
    xq = np.random.default_rng(5).uniform(-1, 1, (20, 2))
    want = np.asarray(jpost.mean(xq))
    np.testing.assert_allclose(post.mean(xq).numpy(), want, rtol=0, atol=1e-8 * np.abs(want).max())


def _radial_regressor_problem(n=200, nq=32):
    rng = np.random.default_rng(41)
    X = rng.uniform(-1.0, 1.0, (n, 2))
    Y = 2.0 + 0.01 * rng.standard_normal(n)
    s = np.linspace(-1.0, 1.0, 5)
    Xa = np.concatenate([np.stack([s, np.full(5, -1.0)], -1), np.stack([s, np.full(5, 1.0)], -1)])
    xq = rng.uniform(-1.0, 1.0, (nq, 2))
    kw = dict(noise_variance=1e-4, precond_rank=32, anchor_X=Xa, anchor_Y=np.zeros(10), anchor_noise=1e-6)
    return X, Y, xq, kw


@pytest.fixture(scope="module")
def radial_regressor_reference():
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor as JaxRegressor

    X, Y, xq, kw = _radial_regressor_problem()
    prior = jlgt.GaussianProcess(jlgt.functions.Zero((2,)), jlgt.kernels.Matern((2,), nu=2.5, lengthscales=0.8))
    reg = JaxRegressor(prior, X, Y, L=-1.0 * jdiffops.Laplacian((2,)), device_cg=True, precond_build="device",
                       compensated=True, tol=1e-10, maxiter=2000, **kw)
    return np.asarray(reg.mean(jnp.asarray(xq))), np.asarray(reg.var(jnp.asarray(xq)))


@pytest.mark.parametrize("mode", ["f64", "ff"])
def test_regressor_on_a_kernel_without_a_spec_matches_jax(radial_regressor_reference, mode):
    """The regressor with the radial kernel -Laplacian k -Laplacian* (no
    sum-of-products spec: its CG matvec is the kept dense Gram, its mean
    gram_matrix(k L*, xq, X) @ w) and anchors, against the JAX regressor:
    the mean within 1e-6 (f64, CG tol 1e-10) and 2e-4 (ff, tol 1e-6) of max
    |mean|, var within 1e-5 of max var (f64)."""
    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor

    X, Y, xq, kw = _radial_regressor_problem()
    prior = lgt.GaussianProcess(lgt.functions.Zero((2,)), lgt.kernels.Matern((2,), nu=2.5, lengthscales=0.8))
    tol = 1e-10 if mode == "f64" else 1e-6
    reg = IterativeGPRegressor(prior, X, Y, L=-1.0 * diffops.Laplacian((2,)), tol=tol, maxiter=2000, mode=mode,
                               device="cpu", **kw)
    assert reg._obs_spec is None and reg._cross_spec is None
    m_ref, v_ref = radial_regressor_reference
    mean = reg.mean(xq).double().numpy()
    bound = 1e-6 if mode == "f64" else 2e-4
    assert np.abs(mean - m_ref).max() <= bound * np.abs(m_ref).max()
    assert reg.solve_info[1] <= tol
    if mode == "f64":
        np.testing.assert_allclose(reg.var(xq).numpy(), v_ref, rtol=0, atol=1e-5 * v_ref.max())
