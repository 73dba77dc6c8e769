"""The ported slice as a whole: gram-free heat-equation GP conditioning.

The PyTorch port's ``IterativeGPRegressor`` (here on the CPU, through the
kernels' plain versions) against the JAX package's
``IterativeGPRegressor(prior, X, Y, L=H, device_cg=True,
precond_build="device", compensated=True)`` on the same seeded problem:
n = 600 heat collocation points, rank-128 Nyström preconditioner, noise
1e-4, posterior mean at 64 queries.  The port gets the kernel as the
specs of ``bench.py::_build_kernels`` (``data/heat_bench_specs.json``),
which the JAX side derives from the same prior and operator.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import linpde_gp_tpu as lgt
from linpde_gp_tpu.models.iterative import IterativeGPRegressor as JaxRegressor
from linpde_gp_tpu.ops import diffops
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.specs import load_specs

torch.set_num_threads(1)

SPECS = load_specs()
KW = dict(noise_variance=1e-4, precond_rank=128)


def _problem(seed=2, n=600, nq=64):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)
    Y = rng.standard_normal(n)
    xq = np.stack([rng.uniform(0, 5, nq), rng.uniform(-1, 1, nq)], -1)
    return X, Y, xq


@pytest.fixture(scope="module")
def reference():
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    X, Y, xq = _problem()
    reg = JaxRegressor(
        prior, X, Y, L=H, device_cg=True, precond_build="device", compensated=True, tol=1e-10, **KW
    )
    return np.asarray(reg.mean(jnp.asarray(xq))), np.asarray(reg.representer_weights)


def _port(mode, tol, Y=None):
    X, Y0, xq = _problem()
    reg = IterativeGPRegressor(
        SPECS["obs"], SPECS["cross"], X, Y0 if Y is None else Y, tol=tol, mode=mode, device="cpu", **KW
    )
    return reg, reg.mean(xq)


def test_f64_matches_jax(reference):
    """Both float64 end to end: agreement at the CG tolerance (the bound
    of test_pcg_r5.py:275)."""
    m_ref, w_ref = reference
    reg, m = _port("f64", 1e-10)
    assert m.dtype == torch.float64 and m.shape == (64,)
    scale = np.abs(m_ref).max()
    assert np.max(np.abs(m.numpy() - m_ref)) <= 1e-6 * scale
    it, rr = reg.solve_info
    assert rr <= 1e-10 and 0 < it <= 512
    np.testing.assert_allclose(reg.representer_weights.numpy(), w_ref, rtol=0, atol=1e-6 * np.abs(w_ref).max())


# float32 modes: the system's condition number is ~n k(0) / sigma^2 ~ 3e6.
# CG runs to 1e-6, about what float32 CG state resolves here (the JAX run
# goes to 1e-10 in float64).  Measured on this problem (CPU): the mean is
# off by 2.7e-5 of max |mean| in ff mode, whose Gram entries and matvec
# sums are carried in float-float, and by 4.4e-4 in plain mode, whose
# float32 sums cancel by ~4e4.  The bounds keep 5-7x headroom.
_F32_MEAN_TOL = {"ff": 2e-4, "plain": 2e-3}


@pytest.mark.parametrize("mode", ["ff", "plain"])
def test_f32_modes_match_jax(reference, mode):
    m_ref, _ = reference
    reg, m = _port(mode, 1e-6)
    assert m.dtype == torch.float32 and m.shape == (64,)
    assert torch.isfinite(m).all()
    assert np.max(np.abs(m.double().numpy() - m_ref)) <= _F32_MEAN_TOL[mode] * np.abs(m_ref).max()
    it, rr = reg.solve_info
    assert rr <= 1e-6 and 0 < it <= 512
    # ff weights come back in float64 (hi + lo of the CG's ff pair).
    assert reg.representer_weights.dtype == (torch.float64 if mode == "ff" else torch.float32)


def test_refit_matches_fresh():
    """refit(Y') reuses the preconditioner and equals a fresh regressor."""
    X, Y, xq = _problem()
    Y2 = np.cos(X[:, 0]) * np.sin(2 * X[:, 1])
    reg, _ = _port("f64", 1e-11)
    precond = reg._precond
    m_refit = reg.refit(Y2).mean(xq)
    assert reg._precond is precond
    _, m_fresh = _port("f64", 1e-11, Y=Y2)
    np.testing.assert_allclose(m_refit.numpy(), m_fresh.numpy(), rtol=0, atol=1e-9 * m_fresh.abs().max().item())


def test_mode_is_explicit():
    X, Y, _ = _problem(n=32)
    with pytest.raises(ValueError, match="mode"):
        IterativeGPRegressor(SPECS["obs"], SPECS["cross"], X, Y, device="cpu")
