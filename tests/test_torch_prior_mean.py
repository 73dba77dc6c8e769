"""Non-zero prior means in the PyTorch port, against the JAX package (on
the CPU, float64 inputs from numpy seeds).

The prior mean is ``m(t, x) = exp(-0.3 t) sin(pi (x + 1) / 2)``, a guess at
the heat IBVP's solution with the wrong decay rate, as a
``LambdaFunction`` in each package; ``H m`` goes through each package's
autodiff (``DiffopFunction``).

- ``IterativeGPRegressor`` with that mean, plain (``u(X) + eps``) and with
  ``L = H``, without and with anchors, in modes f64 and ff, n = 300: the
  mean at 48 queries against the JAX regressor (``device_cg=True,
  precond_build="device"``, float64, CG tol 1e-10) within 1e-6 of max
  |mean| in f64 (CG tol 1e-10) and 2e-4 in ff (CG tol 1e-6; ff's float32
  CG state, the bound of ``test_torch_iterative.py``).
- The shifted-data identity: with the mean, the posterior mean equals a
  zero-mean regressor's on ``Y - (L m)(X)`` and ``Y1 - m(X1)``, plus ``m``
  (f64, within 1e-9 of max |mean|).  ``refit`` recomputes the residual.
- Pickling: a mean built from a module-level function round-trips; one
  from a lambda raises ``PicklingError``, as the JAX regressor does.
- The dense engine (``condition_on_observations``) with the mean, on
  anchors and then heat-operator observations: mean and std at the
  queries, and the mean of ``H`` applied to the posterior, against the JAX
  posterior within 1e-8 of max |mean| (std: 1e-8 of max std).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu.models.iterative import IterativeGPRegressor as JaxRegressor
from linpde_gp_tpu.ops import diffops as jdiffops
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.ops import diffops

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

ALPHA = 0.1
KW = dict(noise_variance=1e-3, precond_rank=64, maxiter=2000)
TOL = {"f64": 1e-10, "ff": 1e-6}
MEAN_BOUND = {"f64": 1e-6, "ff": 2e-4}


def m_torch(x):
    return torch.exp(-0.3 * x[..., 0]) * torch.sin(torch.pi * (x[..., 1] + 1.0) / 2.0)


def m_jax(x):
    return jnp.exp(-0.3 * x[..., 0]) * jnp.sin(jnp.pi * (x[..., 1] + 1.0) / 2.0)


def u_star(X):
    return np.sin(np.pi * (X[..., 1] + 1.0) / 2.0) * np.exp(-ALPHA * (np.pi / 2.0) ** 2 * X[..., 0])


def _kernel(pkg):
    k = pkg.kernels
    return 1.0 * k.TensorProduct(k.Matern((), nu=1.5, lengthscales=2.5), k.Matern((), nu=2.5, lengthscales=2.0))


def _priors(fn=m_torch):
    port = lgt.GaussianProcess(lgt.functions.LambdaFunction(fn, (2,)), _kernel(lgt))
    ref = jlgt.GaussianProcess(jlgt.functions.LambdaFunction(m_jax, (2,)), _kernel(jlgt))
    return port, ref


def _problem(observe, n=300, nq=48):
    """Points, data (``H u* = 0`` or ``u*`` plus a seeded perturbation),
    anchors from u*, queries."""
    rng = np.random.default_rng(21)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1)
    Y = (np.zeros(n) if observe == "H" else u_star(X)) + 1e-2 * rng.standard_normal(n)
    Xa = np.concatenate([np.stack([np.zeros(16), np.linspace(-1.0, 1.0, 16)], -1),
                         np.stack([np.linspace(0.0, 5.0, 8), np.full(8, -1.0)], -1),
                         np.stack([np.linspace(0.0, 5.0, 8), np.full(8, 1.0)], -1)])
    xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], -1)
    return X, Y, Xa, u_star(Xa), xq


def _anchor_kw(anchored, Xa, Ya):
    return dict(anchor_X=Xa, anchor_Y=Ya, anchor_noise=1e-6) if anchored else {}


_JAX = {}


def _jax_mean(observe, anchored):
    key = (observe, anchored)
    if key not in _JAX:
        _, ref = _priors()
        X, Y, Xa, Ya, xq = _problem(observe)
        L = jdiffops.HeatOperator((2,), alpha=ALPHA) if observe == "H" else None
        reg = JaxRegressor(ref, X, Y, L=L, device_cg=True, precond_build="device", compensated=True,
                           tol=1e-10, **KW, **_anchor_kw(anchored, Xa, Ya))
        _JAX[key] = np.asarray(reg.mean(jnp.asarray(xq)))
    return _JAX[key]


def _port(observe, anchored, mode, prior=None, Y=None, **kw):
    port, _ = _priors()
    X, Y0, Xa, Ya, _ = _problem(observe)
    L = diffops.HeatOperator((2,), alpha=ALPHA) if observe == "H" else None
    return IterativeGPRegressor(prior or port, X, Y0 if Y is None else Y, L=L, tol=TOL[mode], mode=mode,
                                device="cpu", **KW, **{**_anchor_kw(anchored, Xa, Ya), **kw})


@pytest.mark.parametrize("mode", ["f64", "ff"])
@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
@pytest.mark.parametrize("observe", ["u", "H"])
def test_regressor_with_prior_mean_matches_jax(observe, anchored, mode):
    reg = _port(observe, anchored, mode)
    xq = _problem(observe)[-1]
    mean = reg.mean(xq)
    assert mean.dtype == (torch.float64 if mode == "f64" else torch.float32) and mean.shape == (48,)
    want = _jax_mean(observe, anchored)
    err = np.abs(mean.double().numpy() - want).max() / np.abs(want).max()
    assert err <= MEAN_BOUND[mode], err
    assert reg.solve_info[1] <= TOL[mode]


def test_observation_mean_is_the_operator_on_the_mean():
    """``L m`` of the regressor is ``DiffopFunction`` autodiff, equal to the
    closed form ``(-0.3 + alpha pi^2 / 4) m`` at the stored points."""
    reg = _port("H", False, "f64")
    X = reg.X.reshape(-1, 2)
    want = (-0.3 + ALPHA * np.pi**2 / 4.0) * m_torch(X)
    got = reg._mean_obs(X)
    assert type(reg._mean_obs).__name__ == "DiffopFunction"
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
def test_mean_equals_zero_mean_on_shifted_data(anchored):
    """m + the zero-mean posterior on the residual data: the identity the
    regressor implements, checked through a second, zero-mean regressor."""
    X, Y, Xa, Ya, xq = _problem("H")
    reg = _port("H", anchored, "f64")
    zero = lgt.GaussianProcess(lgt.functions.Zero((2,)), _kernel(lgt))
    # H m in closed form: (-0.3 + alpha pi^2 / 4) m.
    shift = Y - (-0.3 + ALPHA * np.pi**2 / 4.0) * m_torch(torch.from_numpy(X)).numpy()
    Ya_shift = Ya - m_torch(torch.from_numpy(Xa)).numpy()
    ref = _port("H", anchored, "f64", prior=zero, Y=shift, **_anchor_kw(anchored, Xa, Ya_shift))
    want = ref.mean(xq) + m_torch(torch.from_numpy(xq))
    np.testing.assert_allclose(reg.mean(xq).numpy(), want.numpy(), rtol=0, atol=1e-9 * want.abs().max().item())


def test_refit_recomputes_the_residual():
    X, Y, _, _, xq = _problem("H")
    Y2 = np.cos(X[:, 0]) * 1e-2
    reg = _port("H", False, "f64")
    reg.mean(xq)
    m_refit = reg.refit(Y2).mean(xq)
    m_fresh = _port("H", False, "f64", Y=Y2).mean(xq)
    np.testing.assert_allclose(m_refit.numpy(), m_fresh.numpy(), rtol=0, atol=1e-9 * m_fresh.abs().max().item())


def test_pickling_follows_the_jax_regressor():
    """A named function's mean pickles and gives the same mean after the
    round trip; a lambda's raises, as the JAX regressor's does."""
    named, _ = _priors(m_torch)
    reg = _port("H", True, "f64", prior=named)
    xq = _problem("H")[-1]
    restored = pickle.loads(pickle.dumps(reg))
    assert torch.equal(restored.mean(xq), reg.mean(xq))
    lam, _ = _priors(lambda x: m_torch(x))
    with pytest.raises((pickle.PicklingError, AttributeError)):
        pickle.dumps(_port("H", False, "f64", prior=lam))


def _dense(pkg, dops, fn):
    """Anchors (noise 1e-8), then H u = 0 + eps (noise 1e-6) at 40 points."""
    X, Y, Xa, Ya, xq = _problem("H", n=40)
    prior = pkg.GaussianProcess(pkg.functions.LambdaFunction(fn, (2,)), _kernel(pkg))
    post = prior.condition_on_observations(Ya, X=Xa, b=pkg.Normal(np.zeros(len(Ya)), 1e-8 * np.eye(len(Ya))))
    H = dops.HeatOperator((2,), alpha=ALPHA)
    post = post.condition_on_observations(np.zeros(40), X=X, L=H, b=pkg.Normal(np.zeros(40), 1e-6 * np.eye(40)))
    return post, H, xq


def test_dense_engine_with_prior_mean_matches_jax():
    post, H, xq = _dense(lgt, diffops, m_torch)
    jpost, jH, _ = _dense(jlgt, jdiffops, m_jax)
    mean, std = post.mean(xq).numpy(), post.std(xq).numpy()
    jmean, jstd = np.asarray(jpost.mean(xq)), np.asarray(jpost.std(xq))
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-8 * np.abs(jmean).max())
    np.testing.assert_allclose(std, jstd, rtol=0, atol=1e-8 * jstd.max())
    hm, jhm = H(post).mean(xq).numpy(), np.asarray(jH(jpost).mean(xq))
    np.testing.assert_allclose(hm, jhm, rtol=0, atol=1e-8 * np.abs(jhm).max())
