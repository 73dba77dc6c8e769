"""Posterior variance of the PyTorch port's ``IterativeGPRegressor`` (here
on the CPU, through the kernels' plain versions) against the JAX
package's ``IterativeGPRegressor(..., device_cg=True,
precond_build="device", compensated=True).var`` and a float64 dense
oracle, on the seeded heat problem of ``tests/test_pcg_r5.py:243``
(n = 600 collocation points, rank-128 Nyström preconditioner, noise 1e-4,
blocks of 24 queries), and the banded route of the variance on a
Wendland prior.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import linpde_gp_tpu as lgt
from linpde_gp_tpu.models.iterative import IterativeGPRegressor as JaxRegressor
from linpde_gp_tpu.ops import diffops
from linpde_gp_tpu_torch import GaussianProcess
from linpde_gp_tpu_torch.models.functions import Zero
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.ops import kernels
from linpde_gp_tpu_torch.ops.diffops import HeatOperator
from linpde_gp_tpu_torch.ops.gram import gram_matrix
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu_torch.specs import load_specs
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

KW = dict(noise_variance=1e-4, maxiter=3000, precond_rank=128)
NQ = 48


def _problem(seed=2, n=600, nq=64):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)
    Y = rng.standard_normal(n)
    xq = np.stack([rng.uniform(0, 5, nq), rng.uniform(-1, 1, nq)], -1)
    return X, Y, xq


def heat_prior():
    return GaussianProcess(
        Zero((2,)),
        1.0 * kernels.TensorProduct(
            kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )


@pytest.fixture(scope="module")
def jax_var():
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    X, Y, xq = _problem()
    reg = JaxRegressor(
        prior, X, Y, L=diffops.HeatOperator((2,), alpha=0.1), device_cg=True, precond_build="device",
        compensated=True, tol=1e-10, **KW,
    )
    return np.asarray(reg.var(jnp.asarray(xq[:NQ]), block_size=24))


@pytest.fixture(scope="module")
def dense_var():
    """``k(xq, xq) - k_q (H k H* + s I)^{-1} k_q^T`` in float64, dense."""
    prior, H = heat_prior(), HeatOperator((2,), alpha=0.1)
    X, _, xq = _problem()
    X, xq = torch.from_numpy(X), torch.from_numpy(xq[:NQ])
    k_cross = apply_operator_to_kernel(H, prior.cov, argnum=1)
    k_obs = apply_operator_to_kernel(H, k_cross, argnum=0)
    G = gram_matrix(k_obs, X, X, "f64") + KW["noise_variance"] * torch.eye(X.shape[0], dtype=torch.float64)
    Kq = gram_matrix(k_cross, xq, X, "f64")
    C = torch.linalg.cholesky(G)
    return (prior.cov(xq) - torch.sum(Kq * torch.cholesky_solve(Kq.T, C).T, 1)).numpy()


# (mode, tol, queries, bound relative to max var).  f64 takes the JAX
# test's bound (test_pcg_r5.py:282).  The float32 modes stop CG at 1e-6,
# about what float32 state resolves here; measured on this problem (CPU):
# 2.8e-7 (ff) and 2.2e-7 (plain) of max var from the dense oracle.  ff
# runs one block: its plain version costs ~0.15 s a matvec on the CPU.
_CASES = [("f64", 1e-10, NQ, 1e-5), ("ff", 1e-6, 24, 3e-6), ("plain", 1e-6, NQ, 3e-6)]


@pytest.mark.parametrize("mode,tol,nq,bound", _CASES, ids=[c[0] for c in _CASES])
def test_heat_var_matches_jax_and_dense(jax_var, dense_var, mode, tol, nq, bound):
    X, Y, xq = _problem()
    reg = IterativeGPRegressor(heat_prior(), X, Y, L=HeatOperator((2,), alpha=0.1), tol=tol, mode=mode, device="cpu",
                               **KW)
    var = reg.var(xq[:nq], block_size=24)
    assert var.dtype == (torch.float32 if mode == "plain" else torch.float64) and var.shape == (nq,)
    assert len(reg.var_info) == -(-nq // 24)
    assert all(0 < it < KW["maxiter"] and rr <= tol for it, rr in reg.var_info)
    v = var.double().numpy()
    vscale = np.abs(dense_var).max()
    assert np.max(np.abs(v - dense_var[:nq])) <= bound * vscale
    assert np.max(np.abs(v - jax_var[:nq])) <= bound * vscale + 1e-5 * vscale * (mode == "f64")
    if mode == "plain":  # the cheapest mode: std is the root of the same var
        assert torch.equal(reg.std(xq[:nq], block_size=24), torch.sqrt(var))


def test_var_partitions_agree():
    """Blocks of 24 and one block of 48: different Krylov spaces per column,
    the same variance to the CG tolerance."""
    X, Y, xq = _problem()
    reg = IterativeGPRegressor(heat_prior(), X, Y, L=HeatOperator((2,), alpha=0.1), tol=1e-8, mode="f64",
                               device="cpu", **KW)
    a = reg.var(xq[:NQ], block_size=24).numpy()
    b = reg.var(xq[:NQ], block_size=NQ).numpy()
    assert len(reg.var_info) == 1
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * np.abs(a).max())


def test_var_tol_overrides_the_regressors(dense_var):
    """``var(..., tol=)`` solves the variance blocks to its own tolerance:
    a regressor conditioned at tol 1e-3 gives the f64 test's variance at
    ``tol=1e-10`` (same bound as that case, 1e-5 of max var)."""
    X, Y, xq = _problem()
    reg = IterativeGPRegressor(heat_prior(), X, Y, L=HeatOperator((2,), alpha=0.1), tol=1e-3, mode="f64",
                               device="cpu", **KW)
    reg.var(xq[:24], block_size=24)
    assert reg.var_info[0][1] <= 1e-3 and reg.var_info[0][1] > 1e-10
    var = reg.var(xq[:24], block_size=24, tol=1e-10).numpy()
    assert reg.var_info[0][1] <= 1e-10
    np.testing.assert_allclose(var, dense_var[:24], rtol=0, atol=1e-5 * np.abs(dense_var).max())


def test_var_needs_the_prior():
    specs = load_specs()
    X, Y, xq = _problem(n=64, nq=4)
    reg = IterativeGPRegressor.from_specs(specs["obs"], specs["cross"], X, Y, mode="f64", device="cpu")
    with pytest.raises(ValueError, match="prior"):
        reg.var(xq)


def test_wendland_var_takes_the_banded_route():
    """The Wendland regressor's CG matvec is the banded one, here at r = 16
    right-hand-side columns (the multi-column route on the card); the
    variance against the float64 dense posterior."""
    rng = np.random.default_rng(31)
    n = 768
    X = np.sort(rng.uniform(0.0, 15.0, n))
    xq = np.linspace(0.0, 15.0, 16)
    prior = GaussianProcess(Zero(()), kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5))
    reg = IterativeGPRegressor(prior, X, np.sin(X), noise_variance=1e-3, tol=1e-10, maxiter=600, precond_rank=128,
                               mode="f64", device="cpu")
    assert reg._banded is not None
    widths = []
    plain = reg._banded.plain

    def spy(v, **kw):
        widths.append(v.shape[1] if v.ndim == 2 else 1)
        return plain(v, **kw)

    reg._banded.plain = spy
    var = reg.var(xq, block_size=16).numpy()
    assert widths and set(widths) == {16}
    Xt, xqt = torch.from_numpy(X), torch.from_numpy(xq)
    G = gram_matrix(prior.cov, Xt, Xt, "f64") + 1e-3 * torch.eye(n, dtype=torch.float64)
    Kq = gram_matrix(prior.cov, xqt, Xt, "f64")
    ref = (prior.cov(xqt) - torch.sum(Kq * torch.linalg.solve(G, Kq.T).T, 1)).numpy()
    np.testing.assert_allclose(var, ref, rtol=0, atol=1e-8 * np.abs(ref).max())
