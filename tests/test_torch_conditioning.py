"""The port's dense conditioning engine against a naive dense conditioner
and against the JAX package.

Ports of ``tests/test_conditioning.py`` (float64 on the CPU, through the
kernels' plain versions): each test keeps the JAX original's check and
tolerance, and holds the port to the JAX posterior on the same seeded
numpy inputs.  Further cases: the posterior built from the JAX
posterior's numeric state (evaluation apart from factorization), a
batch-shaped X, the posterior mean's K2 route against ``evaluate @ w``,
and the slice as a whole (a heat IBVP conditioned in four calls).
"""

import numpy as np
import pytest
import scipy.stats
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

#: Port vs the JAX package on the same inputs, relative to the values' scale:
#: the same float64 arithmetic in another order.
JAX_TOL = 1e-10


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_to_jax(port, jax_value, tol=JAX_TOL):
    port, jax_value = _np(port), _np(jax_value)
    assert port.shape == jax_value.shape
    np.testing.assert_allclose(port, jax_value, rtol=0, atol=tol * max(np.max(np.abs(jax_value)), 1e-300))


def naive_gp_regression(kernel_fns, X_blocks, Y_blocks, noise_blocks, x_query, query_kernels):
    """Dense one-shot conditioner over all blocks (the JAX test's helper)."""
    K = np.block(
        [
            [_np(kernel_fns[(i, j)](Xi[:, None], Xj[None, :])) for j, Xj in enumerate(X_blocks)]
            for i, Xi in enumerate(X_blocks)
        ]
    )
    for idx, nb in enumerate(noise_blocks):
        if nb is not None:
            start = sum(len(X_blocks[k]) for k in range(idx))
            sl = slice(start, start + len(X_blocks[idx]))
            K[sl, sl] += nb
    y = np.concatenate([np.asarray(Y) for Y in Y_blocks])
    w = np.linalg.solve(K, y)
    kx = np.concatenate([_np(qk(x_query[:, None], Xj[None, :])) for qk, Xj in zip(query_kernels, X_blocks)], axis=1)
    return kx @ w, K, w, kx


def test_incremental_vs_naive_point_observations():
    rng = np.random.default_rng(7)
    X1, X2 = rng.uniform(-1, 1, 5), rng.uniform(-1, 1, 4)
    Y1, Y2 = np.sin(3 * X1), np.sin(3 * X2)
    noise2 = 0.1**2 * np.eye(4)
    xq = np.linspace(-1, 1, 33)

    def run(pkg):
        k = pkg.kernels.Matern((), nu=2.5, lengthscales=0.7)
        post = pkg.GaussianProcess(pkg.functions.Zero(()), k).condition_on_observations(Y1, X=X1)
        post = post.condition_on_observations(Y2, X=X2, b=pkg.Normal(np.zeros(4), noise2))
        return k, post

    k, post = run(lgt)
    mean, K, w, kx = naive_gp_regression({(i, j): k for i in range(2) for j in range(2)}, [X1, X2], [Y1, Y2],
                                         [None, noise2], xq, [k, k])
    np.testing.assert_allclose(_np(post.mean(xq)), mean, atol=1e-8)
    var_naive = _np(k(xq, xq)) - np.einsum("qn,nm,qm->q", kx, np.linalg.inv(K), kx)
    np.testing.assert_allclose(_np(post.var(xq)), var_naive, atol=1e-8)
    cov_naive = _np(k(xq[:, None], xq[None, :])) - kx @ np.linalg.inv(K) @ kx.T
    np.testing.assert_allclose(_np(post.cov.matrix(xq)), cov_naive, atol=1e-8)

    _, jpost = run(jlgt)
    _close_to_jax(post.mean(xq), jpost.mean(xq))
    _close_to_jax(post.var(xq), jpost.var(xq))
    _close_to_jax(post.cov.matrix(xq), jpost.cov.matrix(xq))


def test_incremental_order_invariance():
    """(A then B) equals (B then A) and (A and B jointly)."""
    XA, XB = np.asarray([-0.7, -0.2, 0.4]), np.asarray([0.1, 0.8])
    YA, YB = np.cos(XA), np.cos(XB)
    xq = np.linspace(-1, 1, 17)

    def run(pkg):
        prior = pkg.GaussianProcess(pkg.functions.Zero(()), 2.0**2 * pkg.kernels.ExpQuad((), lengthscales=0.5))
        ab = prior.condition_on_observations(YA, X=XA).condition_on_observations(YB, X=XB)
        ba = prior.condition_on_observations(YB, X=XB).condition_on_observations(YA, X=XA)
        joint = prior.condition_on_observations(np.concatenate([YA, YB]), X=np.concatenate([XA, XB]))
        return ab, ba, joint

    ab, ba, joint = run(lgt)
    np.testing.assert_allclose(_np(ab.mean(xq)), _np(ba.mean(xq)), atol=1e-9)
    np.testing.assert_allclose(_np(ab.mean(xq)), _np(joint.mean(xq)), atol=1e-9)
    np.testing.assert_allclose(_np(ab.var(xq)), _np(joint.var(xq)), atol=1e-9)
    jab, _, _ = run(jlgt)
    _close_to_jax(ab.mean(xq), jab.mean(xq))
    _close_to_jax(ab.var(xq), jab.var(xq))


def test_operator_observations_vs_naive():
    """PDE-operator observations: the Gram blocks are L0 k L1* evaluations."""
    rng = np.random.default_rng(11)
    X_op, Y_op = rng.uniform(-1, 1, 6), np.ones(6)
    X_pt, Y_pt = np.asarray([-1.0, 1.0]), np.asarray([0.0, 0.5])
    xq = np.linspace(-1, 1, 21)

    def run(pkg, dops):
        k = pkg.kernels.ExpQuad((), lengthscales=0.8)
        D = dops.Derivative(2)
        post = pkg.GaussianProcess(pkg.functions.Zero(()), k).condition_on_observations(Y_op, X=X_op, L=D)
        return k, D, post.condition_on_observations(Y_pt, X=X_pt)

    k, D, post = run(lgt, diffops)
    k_dd = apply_operator_to_kernel(D, apply_operator_to_kernel(D, k, argnum=1), argnum=0)
    k_id_d = apply_operator_to_kernel(D, k, argnum=1)
    k_d_id = apply_operator_to_kernel(D, k, argnum=0)
    mean, *_ = naive_gp_regression({(0, 0): k_dd, (0, 1): k_d_id, (1, 0): k_id_d, (1, 1): k}, [X_op, X_pt],
                                   [Y_op, Y_pt], [None, None], xq, [k_id_d, k])
    np.testing.assert_allclose(_np(post.mean(xq)), mean, atol=1e-7)
    _, _, jpost = run(jlgt, jdiffops)
    # The noiseless operator Gram is ill-conditioned: agreement at its round-off.
    _close_to_jax(post.mean(xq), jpost.mean(xq), tol=1e-7)


def _sin_posterior(pkg, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, 5)
    prior = pkg.GaussianProcess(pkg.functions.Zero(()), pkg.kernels.ExpQuad((), lengthscales=0.8))
    return prior.condition_on_observations(np.sin(2 * X), X=X)


def test_operator_pushforward_reuses_weights():
    """L(posterior) shares the Gram factor and matches finite differences."""
    post = _sin_posterior(lgt)
    dpost = diffops.Derivative(1)(post)
    assert dpost.gram_cholesky is post.gram_cholesky
    xq = np.linspace(-0.9, 0.9, 11)
    h = 1e-6
    fd = (_np(post.mean(xq + h)) - _np(post.mean(xq - h))) / (2 * h)
    np.testing.assert_allclose(_np(dpost.mean(xq)), fd, atol=1e-5)
    jdpost = jdiffops.Derivative(1)(_sin_posterior(jlgt))
    _close_to_jax(dpost.mean(xq), jdpost.mean(xq))
    _close_to_jax(dpost.var(xq), jdpost.var(xq))


def test_functional_application_to_posterior():
    """A functional of the posterior is a Normal through the cached factor."""
    post = _sin_posterior(lgt)
    x = np.asarray([0.1, 0.2])
    rv = post(x)
    assert isinstance(rv, lgt.Normal)
    np.testing.assert_allclose(_np(rv.mean), _np(post.mean(x)), atol=1e-10)
    np.testing.assert_allclose(_np(rv.var), _np(post.var(x)), atol=1e-10)
    jrv = _sin_posterior(jlgt)(x)
    _close_to_jax(rv.mean, jrv.mean)
    _close_to_jax(rv.cov.matrix, jrv.cov.matrix)


def test_noise_via_gp_evaluation():
    """Inverse-problem pattern: ``b = -f_prior(X)`` (a Normal) as correlated noise."""
    X = np.linspace(-0.8, 0.8, 5)
    xq = np.linspace(-1, 1, 9)

    def run(pkg, dops):
        u_prior = pkg.GaussianProcess(pkg.functions.Zero(()), pkg.kernels.ExpQuad((), lengthscales=0.5))
        f_prior = pkg.GaussianProcess(pkg.functions.Zero(()), 10.0**2 * pkg.kernels.ExpQuad((), lengthscales=0.25))
        b = -f_prior(X)
        assert isinstance(b, pkg.Normal)
        return u_prior.condition_on_observations(np.zeros_like(X), X=X, L=-1.0 * dops.Derivative(2), b=b)

    post = run(lgt, diffops)
    assert torch.isfinite(post.mean(xq)).all() and torch.isfinite(post.std(xq)).all()
    jpost = run(jlgt, jdiffops)
    _close_to_jax(post.mean(xq), jpost.mean(xq))
    _close_to_jax(post.std(xq), jpost.std(xq))


def test_log_marginal_likelihood_vs_scipy():
    rng = np.random.default_rng(5)
    X, X2 = rng.uniform(-1, 1, 6), rng.uniform(-1, 1, 3)
    Y, Y2 = np.sin(2 * X), np.sin(2 * X2)
    noise = 0.05**2 * np.eye(6)

    def run(pkg):
        k = pkg.kernels.Matern((), nu=2.5, lengthscales=0.7)
        post = pkg.GaussianProcess(pkg.functions.Zero(()), k).condition_on_observations(
            Y, X=X, b=pkg.Normal(np.zeros(6), noise)
        )
        return k, post, post.condition_on_observations(Y2, X=X2)

    k, post, post2 = run(lgt)
    K = _np(k(X[:, None], X[None, :])) + noise
    expected = scipy.stats.multivariate_normal(np.zeros(6), K).logpdf(Y)
    np.testing.assert_allclose(float(post.log_marginal_likelihood), expected, rtol=1e-10)
    Xj = np.concatenate([X, X2])
    K_joint = _np(k(Xj[:, None], Xj[None, :])).copy()
    K_joint[:6, :6] += noise
    expected2 = scipy.stats.multivariate_normal(np.zeros(9), K_joint, allow_singular=True).logpdf(
        np.concatenate([Y, Y2])
    )
    np.testing.assert_allclose(float(post2.log_marginal_likelihood), expected2, rtol=1e-8)
    _, jpost, jpost2 = run(jlgt)
    np.testing.assert_allclose(float(post2.log_marginal_likelihood), float(jpost2.log_marginal_likelihood), rtol=1e-10)


# -- the heat problem: the iterative regressor, the JAX state, batch shapes ----------


def _heat(pkg, dops):
    prior = pkg.GaussianProcess(
        pkg.functions.Zero((2,)),
        1.0 * pkg.kernels.TensorProduct(
            pkg.kernels.Matern((), nu=1.5, lengthscales=2.5), pkg.kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )
    return prior, dops.HeatOperator((2,), alpha=0.1)


def _heat_points(rng, n):
    return np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)


def test_dense_matches_iterative_regressor_on_heat_data():
    """The dense posterior equals the port's gram-free IterativeGPRegressor
    (f64, tol 1e-10) on the same heat data (the port of
    ``test_iterative_gram_free_regressor_matches_dense``), and the JAX dense
    posterior."""
    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor

    rng = np.random.default_rng(2)
    n, noise = 300, 1e-4
    X, Y, xq = _heat_points(rng, n), rng.standard_normal(n), _heat_points(rng, 17)
    prior, H = _heat(lgt, diffops)
    it = IterativeGPRegressor(prior, X, Y, L=H, noise_variance=noise, tol=1e-10, maxiter=2000, precond_rank=0,
                              mode="f64", device="cpu")
    dense = prior.condition_on_observations(Y, X=X, L=H, b=lgt.Normal(np.zeros(n), noise * np.eye(n)))
    np.testing.assert_allclose(_np(it.mean(xq)), _np(dense.mean(xq)), atol=1e-8)
    np.testing.assert_allclose(_np(it.var(xq)), _np(dense.var(xq)), atol=1e-8)
    jprior, jH = _heat(jlgt, jdiffops)
    jdense = jprior.condition_on_observations(Y, X=X, L=jH, b=jlgt.Normal(np.zeros(n), noise * np.eye(n)))
    _close_to_jax(dense.mean(xq), jdense.mean(xq))
    _close_to_jax(dense.var(xq), jdense.var(xq))


def _ibvp(pkg, dops, n_pde=300, seed=4, noise=1e-6, anchor_noise=1e-8):
    """IC, two BCs, then ``n_pde`` points under the heat operator, each with
    Normal noise: four conditioning calls."""
    rng = np.random.default_rng(seed)
    prior, H = _heat(pkg, dops)
    x_ic = np.linspace(-1.0, 1.0, 12)
    post = prior.condition_on_observations(
        np.sin(np.pi * (x_ic + 1.0) / 2.0), X=np.stack([np.zeros(12), x_ic], -1),
        b=pkg.Normal(np.zeros(12), anchor_noise * np.eye(12)),
    )
    t = np.linspace(0.0, 5.0, 8)
    for xb in (-1.0, 1.0):
        post = post.condition_on_observations(np.zeros(8), X=np.stack([t, np.full(8, xb)], -1),
                                              b=pkg.Normal(np.zeros(8), anchor_noise * np.eye(8)))
    X = _heat_points(rng, n_pde)
    return post.condition_on_observations(np.zeros(n_pde), X=X, L=H,
                                          b=pkg.Normal(np.zeros(n_pde), noise * np.eye(n_pde)))


def test_slice_heat_ibvp_matches_jax():
    """The slice as a whole: IC, two BCs and 300 PDE points under
    HeatOperator, each with Normal noise, through both packages'
    condition_on_observations; mean and std at 50 queries agree to 1e-9 of
    max |mean| and of max std."""
    xq = _heat_points(np.random.default_rng(9), 50)
    post, jpost = _ibvp(lgt, diffops), _ibvp(jlgt, jdiffops)
    assert post.gram_cholesky.shape == (328, 328)
    _close_to_jax(post.mean(xq), jpost.mean(xq), tol=1e-9)
    _close_to_jax(post.std(xq), jpost.std(xq), tol=1e-9)


def test_blocked_var_matches_substitution_and_jax(monkeypatch):
    """The IBVP slice at anchor noise 1e-5 (the benchmark cell's): with
    panels of 64 rows its 328-row factor takes the blocked substitution, whose
    var is within 1e-10 of the substitution route's per query, and whose std
    is the JAX posterior's as in the slice test."""
    from linpde_gp_tpu_torch.ops.linalg import chol as chol_ops

    xq = _heat_points(np.random.default_rng(11), 60)
    post = _ibvp(lgt, diffops, anchor_noise=1e-5)
    jpost = _ibvp(jlgt, jdiffops, anchor_noise=1e-5)
    substituted = post.var(xq)
    assert post._panels is None
    monkeypatch.setattr(chol_ops, "PANEL_ROWS", 64)
    blocked = post.var(xq)
    assert post._panels.inverses.shape == (6, 64, 64)
    assert torch.all((blocked - substituted).abs() <= 1e-10 * substituted)
    _close_to_jax(post.std(xq), jpost.std(xq), tol=1e-9)


def test_state_carried_across_from_jax():
    """A port posterior built from the JAX posterior's chol, residuals and
    representer weights (numpy) evaluates mean, var and cov.matrix as JAX
    does, to 1e-12 of max |value|: evaluation apart from factorization."""
    from linpde_gp_tpu_torch.models.gp import ConditionalGaussianProcess

    jpost = _ibvp(jlgt, jdiffops, n_pde=120)
    post = _ibvp(lgt, diffops, n_pde=120)
    carried = ConditionalGaussianProcess(
        prior=post.prior, Ys=post._Ys, Ls=post._Ls, bs=post._bs, kLas=post.kLas,
        chol=np.asarray(jpost.gram_cholesky), residuals=np.asarray(jpost._residuals),
        representer_weights=np.asarray(jpost.representer_weights),
    )
    xq = _heat_points(np.random.default_rng(10), 40)
    _close_to_jax(carried.mean(xq), jpost.mean(xq), tol=1e-12)
    _close_to_jax(carried.var(xq), jpost.var(xq), tol=1e-12)
    _close_to_jax(carried.cov.matrix(xq), jpost.cov.matrix(xq), tol=1e-12)


def test_batch_shaped_X():
    """Observations at a (5, 5, 2) grid of points and queries on a (4, 3, 2)
    grid: the layouts of Y, the mean and the variance, against JAX."""
    g = np.linspace(-1.0, 1.0, 5)
    X = np.stack(np.meshgrid(np.linspace(0.0, 5.0, 5), g, indexing="ij"), -1)  # (5, 5, 2)
    Y = np.sin(X[..., 0]) * np.cos(X[..., 1])
    xq = np.stack(np.meshgrid(np.linspace(0.2, 4.8, 4), np.linspace(-0.9, 0.9, 3), indexing="ij"), -1)

    def run(pkg, dops):
        prior, _ = _heat(pkg, dops)
        return prior.condition_on_observations(Y, X=X, b=pkg.Normal(np.zeros((5, 5)), 1e-6 * np.eye(25)))

    post, jpost = run(lgt, diffops), run(jlgt, jdiffops)
    mean, var = post.mean(xq), post.var(xq)
    assert mean.shape == (4, 3) and var.shape == (4, 3)
    np.testing.assert_allclose(_np(post.mean(X)), Y, atol=1e-3)
    _close_to_jax(mean, jpost.mean(xq))
    _close_to_jax(var, jpost.var(xq))


def test_mean_k2_route_equals_evaluate():
    """The PDE block's mean route (Eval(X) o H unfolded into K2 on k H*) and
    the point blocks' K2 route give ``evaluate(x) @ w``."""
    post = _ibvp(lgt, diffops, n_pde=80)
    xq = torch.as_tensor(_heat_points(np.random.default_rng(12), 30))
    w = post.representer_weights
    off = 0
    for block in post.kLas:
        assert block.matvec_route == "K2"
        w_b = w[off:off + block.randvar_size]
        off += block.randvar_size
        ref = block.evaluate(xq) @ w_b
        np.testing.assert_allclose(_np(block.matvec(xq, w_b)), _np(ref), rtol=0, atol=1e-12 * _np(ref).__abs__().max())


def test_sample_with_a_generator():
    """``Normal.sample`` / ``GaussianProcess.sample`` take a torch.Generator
    where the JAX package takes a key: a seed gives the same draws, and the
    draws have the marginal's moments (5,000 draws: within 5 standard
    errors)."""
    post = _sin_posterior(lgt)
    x = np.linspace(-0.9, 0.9, 4)
    draws = post.sample(torch.Generator().manual_seed(3), x, sample_shape=(5000,))
    again = post.sample(torch.Generator().manual_seed(3), x, sample_shape=(5000,))
    assert draws.shape == (5000, 4) and torch.equal(draws, again)
    rv = post(x)
    se = rv.std / np.sqrt(5000)
    assert bool(((draws.mean(0) - rv.mean).abs() <= 5 * se + 1e-12).all())
    _close_to_jax(rv.cov.matrix, _sin_posterior(jlgt)(x).cov.matrix)


def test_dirac_and_evaluation_layouts():
    """A batch-shaped X through both evaluation functionals of the heat
    prior: the same marginal, the JAX package's layouts and covariances."""
    from linpde_gp_tpu.ops.functionals import DiracFunctional as JDirac
    from linpde_gp_tpu_torch.ops.functionals import DiracFunctional, _EvaluationFunctional

    X = _heat_points(np.random.default_rng(13), 6).reshape(2, 3, 2)
    prior, _ = _heat(lgt, diffops)
    jprior, _ = _heat(jlgt, jdiffops)
    rv_d = DiracFunctional((2,), (), X)(prior)
    rv_e = _EvaluationFunctional((2,), (), X)(prior)
    assert rv_d.shape == rv_e.shape == (2, 3)
    np.testing.assert_array_equal(rv_d.cov.matrix.numpy(), rv_e.cov.matrix.numpy())
    _close_to_jax(rv_d.cov.matrix, JDirac((2,), (), X)(jprior).cov.matrix)
