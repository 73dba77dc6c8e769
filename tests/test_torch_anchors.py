"""Anchored (initial/boundary-value) conditioning, ``refit`` with anchor
values and checkpointing of the PyTorch port's ``IterativeGPRegressor``
(here on the CPU, through the kernels' plain versions), against the JAX
package and a float64 dense joint posterior.

Ports of ``tests/test_pcg_r5.py::test_regressor_device_cg_hybrid_matches_default``
(its anchored case), ``::test_regressor_refit_matches_fresh``,
``::test_regressor_checkpoint_roundtrip`` and
``tests/test_conditioning.py::test_iterative_regressor_anchored_matches_dense_joint``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import linpde_gp_tpu as lgt
from linpde_gp_tpu.models.iterative import IterativeGPRegressor as JaxRegressor
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.pallas_gram import gram_matrix as jax_gram_matrix
from linpde_gp_tpu.ops.pallas_gram import kernel_term_specs as jax_kernel_term_specs
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as jax_apply
from linpde_gp_tpu_torch import GaussianProcess
from linpde_gp_tpu_torch.models.functions import Zero
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.ops import diffops, kernels
from linpde_gp_tpu_torch.ops.gram import gram_matrix, kernel_term_specs
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu_torch.specs import to_tuple
from linpde_gp_tpu_torch.utils.serialization import load_posterior, save_posterior
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


def _heat_priors():
    port = GaussianProcess(
        Zero((2,)),
        1.0 * kernels.TensorProduct(
            kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )
    ref = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    return port, ref


def _matern_priors(scale=1.0, lengthscales=1.0):
    port = GaussianProcess(Zero(()), scale * kernels.Matern((), nu=2.5, lengthscales=lengthscales))
    ref = lgt.GaussianProcess(lgt.functions.Zero(()), scale * lgt.kernels.Matern((), nu=2.5, lengthscales=lengthscales))
    return port, ref


@pytest.mark.parametrize("case", ["heat", "laplacian"])
def test_k_Lk_spec_matches_jax(case):
    """``(L k)`` (the anchors' cross-covariance W) derived by the symbolic
    layer equals the JAX package's spec, tuple for tuple."""
    if case == "heat":
        (port, ref), L, Lj = _heat_priors(), diffops.HeatOperator((2,), alpha=0.1), jdiffops.HeatOperator((2,), alpha=0.1)
    else:
        (port, ref), L, Lj = _matern_priors(), -1.0 * diffops.Laplacian(()), -1.0 * jdiffops.Laplacian(())
    got = kernel_term_specs(apply_operator_to_kernel(L, port.cov, argnum=0))
    want = to_tuple(jax_kernel_term_specs(jax_apply(Lj, ref.cov, argnum=0)))
    assert got == want


@pytest.mark.parametrize("case", ["k", "k_Lk", "k_LkL"])
def test_gram_matrix_matches_jax(case):
    """The Gram router ``gram_matrix(kernel, X0, X1, mode)`` (the anchors'
    ``A11``, ``W`` and the variance's ``kxX``) against the JAX package's
    ``gram_matrix`` in float64, on the heat prior."""
    (port, ref), L, Lj = _heat_priors(), diffops.HeatOperator((2,), alpha=0.1), jdiffops.HeatOperator((2,), alpha=0.1)
    k, kj = port.cov, ref.cov
    if case != "k":
        k, kj = apply_operator_to_kernel(L, k, argnum=0), jax_apply(Lj, kj, argnum=0)
    if case == "k_LkL":
        k, kj = apply_operator_to_kernel(L, k, argnum=1), jax_apply(Lj, kj, argnum=1)
    rng = np.random.default_rng(12)
    X0 = np.stack([rng.uniform(0, 5, 40), rng.uniform(-1, 1, 40)], -1)
    X1 = np.stack([rng.uniform(0, 5, 56), rng.uniform(-1, 1, 56)], -1)
    got = gram_matrix(k, torch.from_numpy(X0), torch.from_numpy(X1), "f64").numpy()
    want = np.asarray(jax_gram_matrix(kj, jnp.asarray(X0), jnp.asarray(X1)))
    assert got.shape == (40, 56)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_gram_matrix_without_a_spec_raises():
    """A kernel without a sum-of-products spec (a general-nu Matérn) no
    longer raises: ``gram_matrix`` evaluates it by its own ``_evaluate``, in
    float64, as the JAX package's ``gram_matrix`` falls back to
    ``kernel.matrix``, and returns the mode's dtype."""
    k, kj = kernels.Matern((), nu=1.2, lengthscales=0.7), lgt.kernels.Matern((), nu=1.2, lengthscales=0.7)
    X0 = np.random.default_rng(13).uniform(-1, 1, 9)
    X1 = np.random.default_rng(14).uniform(-1, 1, 7)
    want = np.asarray(jax_gram_matrix(kj, jnp.asarray(X0), jnp.asarray(X1)))
    got = gram_matrix(k, torch.from_numpy(X0), torch.from_numpy(X1), "f64")
    assert got.dtype == torch.float64 and got.shape == (9, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    assert gram_matrix(k, torch.from_numpy(X0), mode="ff").dtype == torch.float32


def _dense_joint(prior, L, X, Y, noise, Xa, Ya, anoise, xq):
    """Mean and variance of the float64 dense joint posterior on
    ``u(Xa) + e1`` and ``L u(X) + e2``."""
    k = prior.cov
    kL = apply_operator_to_kernel(L, k, argnum=0)
    kLs = apply_operator_to_kernel(L, k, argnum=1)
    kLL = apply_operator_to_kernel(L, kLs, argnum=0)
    X, Xa, xq = (torch.as_tensor(a, dtype=torch.float64) for a in (X, Xa, xq))
    A11 = gram_matrix(k, Xa, Xa, "f64") + anoise * torch.eye(Xa.shape[0], dtype=torch.float64)
    A22 = gram_matrix(kLL, X, X, "f64") + noise * torch.eye(X.shape[0], dtype=torch.float64)
    W = gram_matrix(kL, X, Xa, "f64")
    G = torch.cat([torch.cat([A11, W.T], 1), torch.cat([W, A22], 1)], 0)
    Kq = torch.cat([gram_matrix(k, xq, Xa, "f64"), gram_matrix(kLs, xq, X, "f64")], 1)
    y = torch.cat([torch.as_tensor(Ya, dtype=torch.float64), torch.as_tensor(Y, dtype=torch.float64)])
    mean = Kq @ torch.linalg.solve(G, y)
    var = k(xq) - torch.sum(Kq * torch.linalg.solve(G, Kq.T).T, 1)
    return mean.numpy(), var.numpy()


@pytest.fixture(scope="module")
def heat_anchored():
    """test_pcg_r5.py:243's anchored heat problem: the JAX package's
    default regressor and the dense joint posterior."""
    port, ref = _heat_priors()
    rng = np.random.default_rng(2)
    n = 600
    X = np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)
    Y = rng.standard_normal(n)
    Xa = np.stack([np.zeros(24), np.linspace(-1, 1, 24)], -1)
    Ya = np.sin(np.pi * Xa[:, 1])
    xq = np.stack([rng.uniform(0, 5, 64), rng.uniform(-1, 1, 64)], -1)
    kw = dict(noise_variance=1e-4, tol=1e-10, maxiter=3000, precond_rank=128, anchor_X=Xa, anchor_Y=Ya,
              anchor_noise=1e-8)
    jreg = JaxRegressor(ref, X, Y, L=jdiffops.HeatOperator((2,), alpha=0.1), **kw)
    jax_out = np.asarray(jreg.mean(jnp.asarray(xq))), np.asarray(jreg.var(jnp.asarray(xq[:48]), block_size=24))
    dense = _dense_joint(port, diffops.HeatOperator((2,), alpha=0.1), X, Y, 1e-4, Xa, Ya, 1e-8, xq)
    return port, X, Y, xq, kw, jax_out, dense


def test_anchored_heat_f64_matches_jax_and_dense(heat_anchored):
    """The bounds of test_pcg_r5.py:275-282, against both references."""
    port, X, Y, xq, kw, (m_jax, v_jax), (m_dense, v_dense) = heat_anchored
    reg = IterativeGPRegressor(port, X, Y, L=diffops.HeatOperator((2,), alpha=0.1), mode="f64", device="cpu", **kw)
    m = reg.mean(xq).numpy()
    scale = np.abs(m_dense).max()
    assert np.max(np.abs(m - m_dense)) <= 1e-6 * scale + 1e-8
    assert np.max(np.abs(m - m_jax)) <= 1e-6 * scale + 1e-8
    it, rr = reg.solve_info
    assert rr <= 1e-9 and 0 < it < 3000
    assert reg.anchor_weights.shape == (24,) and reg.anchor_weights.dtype == torch.float64
    v = reg.var(xq[:48], block_size=24).numpy()
    vscale = np.abs(v_dense).max()
    assert np.max(np.abs(v - v_dense[:48])) <= 1e-5 * vscale
    assert np.max(np.abs(v - v_jax)) <= 1e-5 * vscale


def test_anchored_heat_ff_var(heat_anchored):
    """Mode ff: float32 K2 results minus the Schur correction formed in
    float64, split into an ff pair for the CG.  CG to 1e-6 (what float32
    state resolves); measured on this problem (CPU): 3.5e-6 of max var at
    64 queries.  One block of 24: the ff plain version is slow on the CPU."""
    port, X, Y, xq, kw, _, (_, v_dense) = heat_anchored
    reg = IterativeGPRegressor(port, X, Y, L=diffops.HeatOperator((2,), alpha=0.1), mode="ff", device="cpu",
                               **dict(kw, tol=1e-6))
    v = reg.var(xq[:24], block_size=24)
    assert v.dtype == torch.float64
    assert np.max(np.abs(v.numpy() - v_dense[:24])) <= 2e-5 * np.abs(v_dense).max()


def test_anchored_laplacian_matches_dense_joint():
    """test_conditioning.py:224: boundary anchors of a 1-D Poisson problem,
    noise 1e-8, anchor noise 1e-10; the mean and variance at atol 1e-8
    against the dense joint posterior and the JAX regressor."""
    port, ref = _matern_priors(scale=2.0**2)
    X = np.linspace(-0.95, 0.95, 120)
    Y = np.full(120, 2.0)
    Xb, Yb = np.asarray([-1.0, 1.0]), np.asarray([0.0, 1.0])
    xq = np.linspace(-1, 1, 17)
    kw = dict(noise_variance=1e-8, tol=1e-12, maxiter=4000, anchor_X=Xb, anchor_Y=Yb, anchor_noise=1e-10)
    reg = IterativeGPRegressor(port, X, Y, L=-1.0 * diffops.Laplacian(()), mode="f64", device="cpu", **kw)
    m, v = reg.mean(xq).numpy(), reg.var(xq).numpy()
    m_ref, v_ref = _dense_joint(port, -1.0 * diffops.Laplacian(()), X, Y, 1e-8, Xb, Yb, 1e-10, xq)
    np.testing.assert_allclose(m, m_ref, atol=1e-8)
    np.testing.assert_allclose(v, v_ref, atol=1e-8)
    jreg = JaxRegressor(ref, X, Y, L=-1.0 * jdiffops.Laplacian(()), **kw)
    np.testing.assert_allclose(m, np.asarray(jreg.mean(xq)), atol=1e-8)
    np.testing.assert_allclose(v, np.asarray(jreg.var(xq)), atol=1e-8)


def _refit_problem():
    port, _ = _matern_priors()
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(-1, 1, 200))
    kw = dict(L=-1.0 * diffops.Laplacian(()), noise_variance=1e-6, tol=1e-11, maxiter=2000, precond_rank=48,
              anchor_X=np.asarray([-1.0, 1.0]), anchor_noise=1e-10, mode="f64", device="cpu")
    return port, X, kw


def test_refit_with_anchor_values_matches_fresh():
    """test_pcg_r5.py:285: refit(Y', anchor_Y=Ya') reuses the factors and
    equals a fresh regressor on the new data."""
    port, X, kw = _refit_problem()
    Y1, Ya1 = np.sin(2 * X), np.asarray([0.3, -0.1])
    Y2, Ya2 = np.cos(3 * X), np.asarray([-0.2, 0.4])
    xq = np.linspace(-1, 1, 33)
    reg = IterativeGPRegressor(port, X, Y1, anchor_Y=Ya1, **kw)
    reg.mean(xq)
    precond, chol1 = reg._precond, reg._anchors["chol1"]
    m_refit = reg.refit(Y2, anchor_Y=Ya2).mean(xq).numpy()
    assert reg._precond is precond and reg._anchors["chol1"] is chol1
    m_fresh = IterativeGPRegressor(port, X, Y2, anchor_Y=Ya2, **kw).mean(xq).numpy()
    np.testing.assert_allclose(m_refit, m_fresh, rtol=0, atol=1e-9 * max(np.abs(m_fresh).max(), 1.0))


def test_refit_anchor_values_need_anchors():
    port, X, kw = _refit_problem()
    kw = {k: v for k, v in kw.items() if not k.startswith("anchor")}
    reg = IterativeGPRegressor(port, X, np.sin(X), **kw)
    with pytest.raises(ValueError, match="anchors"):
        reg.refit(np.cos(X), anchor_Y=[0.0, 1.0])


def test_u_star_matches_the_jax_ibvp_solution():
    """chip_smoke's numpy u* equals the JAX package's analytic solution of
    experiments/large_scale_tpu.py's problem."""
    ibvp = lgt.problems.HeatEquationDirichletProblem(
        t0=0.0, T=5.0, spatial_domain=lgt.domains.asdomain([-1.0, 1.0]), alpha=0.1,
        initial_values=lgt.functions.TruncatedSineSeries(lgt.domains.asdomain([-1.0, 1.0]), coefficients=[1.0]),
    )
    X = np.stack([np.random.default_rng(4).uniform(0, 5, 32), np.linspace(-1, 1, 32)], -1)
    np.testing.assert_allclose(chip_smoke.u_star(X), np.asarray(ibvp.solution(jnp.asarray(X))), rtol=0, atol=1e-14)
    Xa, Ya = chip_smoke.ibvp_anchors(96, 48)
    assert Xa.shape == (192, 2) and Xa.dtype == np.float32
    np.testing.assert_allclose(Ya, np.asarray(ibvp.solution(jnp.asarray(Xa.astype(np.float64)))), atol=1e-7)


def _checkpoint_cases():
    """(name, regressor factory, queries): test_pcg_r5.py:315's problem,
    the same with boundary anchors, and a banded (Wendland) regressor."""
    port, _ = _matern_priors()
    rng = np.random.default_rng(8)
    X = np.sort(rng.uniform(-1, 1, 160))
    kw = dict(noise_variance=1e-6, tol=1e-11, precond_rank=32, maxiter=2000, mode="f64", device="cpu")
    wend = GaussianProcess(Zero(()), kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5))
    Xw = np.sort(np.random.default_rng(31).uniform(0.0, 15.0, 768))
    return {
        "plain": (lambda Y: IterativeGPRegressor(port, X, Y, **kw), X, np.linspace(-1, 1, 17)),
        "anchored": (lambda Y: IterativeGPRegressor(port, X, Y, L=-1.0 * diffops.Laplacian(()), anchor_X=[-1.0, 1.0],
                                                    anchor_Y=[0.1, 0.2], anchor_noise=1e-10, **kw),
                     X, np.linspace(-1, 1, 17)),
        "banded": (lambda Y: IterativeGPRegressor(wend, Xw, Y, **dict(kw, noise_variance=1e-3, precond_rank=128)),
                   Xw, np.linspace(0.0, 15.0, 16)),
    }


@pytest.mark.parametrize("case", ["plain", "anchored", "banded"])
def test_checkpoint_roundtrip(tmp_path, case):
    """save_posterior / load_posterior: the solved state survives, the
    mean is identical, the banded schedule is rebuilt, and the restored
    regressor refits like a fresh one."""
    make, X, xq = _checkpoint_cases()[case]
    reg = make(np.sin(4 * X))
    m0 = reg.mean(xq).numpy()
    path = tmp_path / "reg.pkl"
    save_posterior(path, reg)
    reg2 = load_posterior(path, device="cpu")
    assert reg2.device == torch.device("cpu") and reg2._weights is not None
    assert (reg2._banded is None) == (reg._banded is None) and (case == "banded") == (reg2._banded is not None)
    np.testing.assert_allclose(reg2.mean(xq).numpy(), m0, rtol=0, atol=1e-12)
    m2 = reg2.refit(np.cos(4 * X)).mean(xq).numpy()
    fresh = make(np.cos(4 * X)).mean(xq).numpy()
    np.testing.assert_allclose(m2, fresh, rtol=0, atol=1e-8 * max(np.abs(fresh).max(), 1.0))
