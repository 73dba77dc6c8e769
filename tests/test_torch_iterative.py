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
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.specs import load_specs

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

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
    reg = IterativeGPRegressor.from_specs(
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
        IterativeGPRegressor.from_specs(SPECS["obs"], SPECS["cross"], X, Y, device="cpu")


# -- the prior / L constructor ---------------------------------------------------------


def _heat_prior():
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops import kernels

    return GaussianProcess(
        Zero((2,)),
        1.0 * kernels.TensorProduct(
            kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )


def test_prior_and_operator_equal_the_specs():
    """``IterativeGPRegressor(prior, X, Y, L=H)`` derives the benchmark's
    specs and then runs exactly what ``from_specs`` runs."""
    from linpde_gp_tpu_torch.ops.diffops import HeatOperator

    X, Y, xq = _problem()
    reg = IterativeGPRegressor(
        _heat_prior(), X, Y, L=HeatOperator((2,), alpha=0.1), tol=1e-10, mode="f64", device="cpu", **KW
    )
    assert reg._obs_spec == SPECS["obs"] and reg._cross_spec == SPECS["cross"]
    assert reg._banded is None
    ref, m_ref = _port("f64", 1e-10)
    assert torch.equal(reg.mean(xq), m_ref)
    assert reg.solve_info == ref.solve_info


def test_prior_checks():
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models import functions as lgtt_functions
    from linpde_gp_tpu_torch.models.functions import Polynomial
    from linpde_gp_tpu_torch.ops import kernels

    X, Y, _ = _problem(n=32)
    # A non-zero prior mean is accepted (tests/test_torch_prior_mean.py holds
    # it to the JAX regressor); a multi-output prior is not.
    gp = GaussianProcess(Polynomial([1.0, 2.0]), kernels.Matern((), nu=1.5))
    reg = IterativeGPRegressor(gp, X[:, 0], Y, mode="f64", device="cpu", noise_variance=1e-3, tol=1e-10)
    assert torch.isfinite(reg.mean(X[:4, 0])).all()
    multi = GaussianProcess(
        lgtt_functions.Zero((), (2,)), kernels.IndependentMultiOutputCovarianceFunction(kernels.Matern(()), kernels.Matern(()))
    )
    with pytest.raises(ValueError, match="scalar outputs"):
        IterativeGPRegressor(multi, X[:, 0], Y, mode="f64", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        IterativeGPRegressor(_heat_prior(), X, Y, device="cpu")


# -- compact support: the banded route (test_wendland_fast.py:220 port) ----------------


@pytest.fixture(scope="module")
def wendland_case():
    """n = 768 sorted points on [0, 15], Wendland(k=1, l=0.5), noise 1e-3,
    rank 128, column tiles of 64 in both packages."""
    from linpde_gp_tpu.config import config as jax_config

    rng = np.random.default_rng(31)
    n = 768
    X = np.sort(rng.uniform(0.0, 15.0, n))
    Y = np.sin(X)
    xq = np.linspace(0.0, 15.0, 64)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), lgt.kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5))
    saved = jax_config.matvec_tile
    jax_config.set(matvec_tile=64)
    try:
        jreg = JaxRegressor(prior, X, Y, noise_variance=1e-3, tol=1e-8, maxiter=600, precond_rank=128)
        jax_out = dict(
            band=(jreg._banded.band_tiles, jreg._banded.total_tiles),
            w=np.asarray(jreg.representer_weights),
            mean=np.asarray(jreg.mean(jnp.asarray(xq))),
        )
    finally:
        jax_config.set(matvec_tile=saved)
    G = np.asarray(prior.cov.matrix(jnp.asarray(X))) + 1e-3 * np.eye(n)
    w_ref = np.linalg.solve(G, Y)
    mean_ref = np.asarray(prior.cov.matrix(jnp.asarray(xq), jnp.asarray(X))) @ w_ref
    return X, Y, xq, jax_out, w_ref, mean_ref


def test_wendland_routes_banded(wendland_case):
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.config import config
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops import kernels

    X, Y, xq, jax_out, w_ref, mean_ref = wendland_case
    prior = GaussianProcess(Zero(()), kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5))
    saved = config.matvec_tile
    config.matvec_tile = 64
    try:
        reg = IterativeGPRegressor(
            prior, X, Y, noise_variance=1e-3, tol=1e-8, maxiter=600, precond_rank=128, mode="f64", device="cpu"
        )
    finally:
        config.matvec_tile = saved
    assert reg._banded is not None, "banded matvec not routed"
    assert (reg._banded.band_tiles, reg._banded.total_tiles) == jax_out["band"]
    assert reg._banded.band_tiles < reg._banded.total_tiles
    w = reg.representer_weights.numpy()
    # The JAX test's bounds against the dense f64 solve: CG tol 1e-8 leaves
    # ~1e-6 relative weight error on this ill-conditioned Gram.
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=1e-5 * np.abs(w_ref).max())
    mean = reg.mean(xq).numpy()
    np.testing.assert_allclose(mean, mean_ref, rtol=0, atol=1e-6)
    # The JAX regressor on the same data, within the sum of both bounds.
    np.testing.assert_allclose(w, jax_out["w"], rtol=0, atol=2e-5 * np.abs(w_ref).max())
    np.testing.assert_allclose(mean, jax_out["mean"], rtol=0, atol=2e-6)


def test_batch_shaped_queries_match_jax():
    """Queries on a (4, 3, 2) grid (ROADMAP Queue 3's batch-shaped-query
    fault): heat prior, n = 300, noise 1e-4, rank 0, tol 1e-10, f64 on the
    CPU; mean and var of shape (4, 3), within 1e-6 of max |mean| of the JAX
    regressor."""
    from linpde_gp_tpu_torch.ops.diffops import HeatOperator

    rng = np.random.default_rng(2)
    n = 300
    X = np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)
    Y = rng.standard_normal(n)
    xq = np.stack(np.meshgrid(np.linspace(0.5, 4.5, 4), np.linspace(-0.8, 0.8, 3), indexing="ij"), -1)
    kw = dict(noise_variance=1e-4, precond_rank=0, tol=1e-10)
    reg = IterativeGPRegressor(_heat_prior(), X, Y, L=HeatOperator((2,), alpha=0.1), mode="f64", device="cpu", **kw)
    jprior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5), lgt.kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )
    jreg = JaxRegressor(jprior, X, Y, L=diffops.HeatOperator((2,), alpha=0.1), **kw)
    m_ref, v_ref = np.asarray(jreg.mean(jnp.asarray(xq))), np.asarray(jreg.var(jnp.asarray(xq)))
    mean, var = reg.mean(xq), reg.var(xq)
    assert mean.shape == (4, 3) and var.shape == (4, 3) and m_ref.shape == (4, 3)
    scale = np.abs(m_ref).max()
    np.testing.assert_allclose(mean.numpy(), m_ref, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(var.numpy(), v_ref, rtol=0, atol=1e-6 * scale)
    # The same queries flattened give the same values.
    np.testing.assert_array_equal(reg.mean(xq.reshape(12, 2)).numpy(), mean.numpy().reshape(12))


@pytest.mark.parametrize("mode", ["ff", "f64"])
def test_precond_rank_above_n_is_rank_n(mode):
    """A ``precond_rank`` above the number of points is clamped to it: the
    attribute reads n, and the weights, solve info and mean are those of an
    explicit ``precond_rank = n``, bit for bit."""
    from linpde_gp_tpu_torch.ops.diffops import HeatOperator

    X, Y, xq = _problem(n=200, nq=16)
    kw = dict(L=HeatOperator((2,), alpha=0.1), noise_variance=1e-4, tol=1e-8, mode=mode, device="cpu")
    big = IterativeGPRegressor(_heat_prior(), X, Y, precond_rank=10_000, **kw)
    exact = IterativeGPRegressor(_heat_prior(), X, Y, precond_rank=200, **kw)
    assert big.precond_rank == exact.precond_rank == 200
    assert torch.equal(big.representer_weights, exact.representer_weights)
    assert big.solve_info == exact.solve_info
    assert torch.equal(big.mean(xq), exact.mean(xq))


def test_no_card_and_no_device_raises(monkeypatch):
    """The port runs on the card unless asked for the CPU: without a card and
    without ``device=`` or ``config.device``, resolving the device and
    building a regressor raise, naming how to ask for the CPU."""
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.config import resolve_device
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops import diffops as port_diffops
    from linpde_gp_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config, "device", None)
    with pytest.raises(RuntimeError, match='config.device = "cpu"'):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    cov = 1.0 * kernels.TensorProduct(kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5))
    prior = GaussianProcess(Zero((2,)), cov, device="cpu")
    X, Y, _ = _problem(n=50)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        IterativeGPRegressor(prior, X, Y, L=port_diffops.HeatOperator((2,), alpha=0.1), mode="f64")
    reg = IterativeGPRegressor(prior, X, Y, L=port_diffops.HeatOperator((2,), alpha=0.1), mode="f64", device="cpu")
    assert reg.X.device == torch.device("cpu")
