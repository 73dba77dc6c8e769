"""The port's Lebesgue-integral functionals against the JAX package.

Ports of ``tests/test_functionals.py:24-76`` and ``:134-200`` (float64 on
the CPU, through the kernels' plain versions): the exact ``\\int k`` and
``\\int\\int k`` of half-integer Matérn kernels, the integral of a
transformed kernel, and conditioning on an integral observation, each with
the JAX test's oracle and tolerance and against the JAX result on the same
inputs (``JAX_TOL`` of the values' scale, or 1e-12 for closed forms).
Also: the ``LebesgueIntegral`` doctest value; a Box integral ([0, 5] x
[-1, 1], order 16 x 2 panels) of a small heat posterior and the Gaussian
update of conditioning on it, against the JAX package; the node-blocked
contraction against the unblocked one (1e-13); and the ``evaluate @ w``
route wherever an exact hook applies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu.config import config as jconfig
from linpde_gp_tpu.ops.crosscov.base import apply_functional_to_crosscov as japply_functional_to_crosscov
from linpde_gp_tpu.ops.transforms import apply_functional as japply_functional
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as japply_operator_to_kernel
from linpde_gp_tpu.ops.transforms import integrals_exact as jie
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.crosscov import base as crosscov_base
from linpde_gp_tpu_torch.ops.crosscov.base import KernelFunctionalCrossCov, apply_functional_to_crosscov
from linpde_gp_tpu_torch.ops.functionals import LebesgueIntegral
from linpde_gp_tpu_torch.ops.transforms import apply_functional, apply_operator_to_kernel
from linpde_gp_tpu_torch.ops.transforms import integrals_exact as ie

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

#: Port vs the JAX package on the same inputs, relative to the values' scale.
JAX_TOL = 1e-10

rng = np.random.default_rng(13)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _close(port, ref, tol):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * max(np.max(np.abs(ref)), 1e-300))


@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_integral_crosscov_vs_scipy_quad(nu):
    """``(\\int k)(x) = \\int k(x, t) dt`` against adaptive quadrature, and
    the JAX package's."""
    k = 1.7 * lgt.kernels.Matern((), nu=nu, lengthscales=0.6)
    I = LebesgueIntegral(lgt.domains.Interval(-1.0, 1.0))
    crosscov = apply_functional(I, k, argnum=1)
    xs = rng.uniform(-1, 1, 5)
    ours = crosscov(xs).numpy()[:, 0]
    expected = [scipy.integrate.quad(lambda t, x=x: float(k(_t(x), _t(t))), -1, 1)[0] for x in xs]
    np.testing.assert_allclose(ours, expected, atol=1e-10)
    jk = 1.7 * jlgt.kernels.Matern((), nu=nu, lengthscales=0.6)
    jI = jlgt.functionals.LebesgueIntegral(jlgt.domains.Interval(-1.0, 1.0))
    _close(ours, np.asarray(japply_functional(jI, jk, argnum=1)(jnp.asarray(xs)))[:, 0], 1e-12)
    assert crosscov.matvec_route == "evaluate @ w"


def test_double_integral_gram_vs_scipy_dblquad():
    """The ``\\int\\int k`` Gram entry against dblquad, and the JAX package's."""
    k = lgt.kernels.Matern((), nu=1.5, lengthscales=0.8)
    I = LebesgueIntegral(lgt.domains.Interval(-0.5, 1.0))
    ours = float(apply_functional_to_crosscov(I, apply_functional(I, k, argnum=1)).matrix[0, 0])
    expected = scipy.integrate.dblquad(lambda s, t: float(k(_t(s), _t(t))), -0.5, 1.0, -0.5, 1.0)[0]
    np.testing.assert_allclose(ours, expected, rtol=1e-9)
    jk = jlgt.kernels.Matern((), nu=1.5, lengthscales=0.8)
    jI = jlgt.functionals.LebesgueIntegral(jlgt.domains.Interval(-0.5, 1.0))
    np.testing.assert_allclose(
        ours, float(japply_functional_to_crosscov(jI, japply_functional(jI, jk, argnum=1)).matrix[0, 0]), rtol=1e-12
    )


def test_integral_of_transformed_kernel_vs_quad():
    """A functional after an operator: ``\\int (d^2 k / dx0^2)(x, t) dt``
    (Gauss-Legendre panels) against quad, and the JAX package's."""
    kD = apply_operator_to_kernel(lgt.diffops.Derivative(2), lgt.kernels.ExpQuad((), lengthscales=0.7), argnum=0)
    crosscov = apply_functional(LebesgueIntegral(lgt.domains.Interval(-1.0, 1.0)), kD, argnum=1)
    ours = float(crosscov(_t(0.3))[0])
    expected = scipy.integrate.quad(lambda t: float(kD(_t(0.3), _t(t))), -1, 1)[0]
    np.testing.assert_allclose(ours, expected, atol=1e-11)
    assert crosscov.matvec_route == "K2"
    jkD = japply_operator_to_kernel(jlgt.diffops.Derivative(2), jlgt.kernels.ExpQuad((), lengthscales=0.7), argnum=0)
    jcc = japply_functional(jlgt.functionals.LebesgueIntegral(jlgt.domains.Interval(-1.0, 1.0)), jkD, argnum=1)
    np.testing.assert_allclose(ours, float(jcc(jnp.asarray(0.3))[0]), rtol=1e-13)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
def test_exact_matern_integral_vs_quadrature(nu):
    """The exact antiderivatives against a kink-split Gauss-Legendre oracle
    (1e-10) and the stationarity identity for the double integral (1e-8),
    as the JAX test; the engine routes through them; all against the JAX
    package's closed forms (1e-12)."""
    l, a, b = 0.8, -0.7, 1.1
    k = 2.3 * lgt.kernels.Matern((), nu=nu, lengthscales=l)
    I = LebesgueIntegral(lgt.domains.Interval(a, b))
    crosscov_fn, gram = ie.exact_integral_hooks(k, I)
    xs = rng.uniform(-1.5, 1.5, 7)  # points outside the domain too
    exact = crosscov_fn(_t(xs)).numpy()
    gl_x, gl_w = np.polynomial.legendre.leggauss(96)

    def gl_interval(lo, hi):
        return 0.5 * (hi - lo) * gl_x + 0.5 * (hi + lo), 0.5 * (hi - lo) * gl_w

    quad = []
    for x in xs:
        s = min(max(x, a), b)  # split at the |x - t| kink
        total = 0.0
        for lo, hi in ((a, s), (s, b)):
            if hi > lo:
                t, wt = gl_interval(lo, hi)
                total += float(wt @ k(_t(np.full_like(t, x)), _t(t)).numpy())
        quad.append(total)
    np.testing.assert_allclose(exact, quad, atol=1e-10)
    # \int\int_[a,b]^2 f(|s - t|) = 2 \int_0^L (L - u) f(u) du,  L = b - a.
    u, wu = gl_interval(0.0, b - a)
    dbl = float(2.0 * (wu * (b - a - u)) @ k(_t(np.zeros_like(u)), _t(u)).numpy())
    np.testing.assert_allclose(gram, dbl, rtol=1e-8)
    crosscov = apply_functional(I, k, argnum=1)
    np.testing.assert_allclose(crosscov(_t(xs)).numpy()[:, 0], exact, atol=1e-12)
    np.testing.assert_allclose(float(apply_functional_to_crosscov(I, crosscov).matrix[0, 0]), gram, rtol=1e-12)
    assert crosscov.matvec_route == "evaluate @ w"
    jhook = jie.exact_integral_hooks(
        2.3 * jlgt.kernels.Matern((), nu=nu, lengthscales=l), jlgt.functionals.LebesgueIntegral(jlgt.domains.Interval(a, b))
    )
    _close(exact, jhook[0](jnp.asarray(xs)), 1e-12)
    np.testing.assert_allclose(gram, jhook[1], rtol=1e-13)


def test_conditioning_on_exact_integral_observation():
    """A Matérn GP conditioned on an integral observation interpolates it;
    the posterior matches the JAX package's."""
    def run(pkg):
        I = pkg.functionals.LebesgueIntegral(pkg.domains.Interval(-1.0, 1.0))
        prior = pkg.GaussianProcess(pkg.functions.Zero(()), pkg.kernels.Matern((), nu=2.5, lengthscales=0.7))
        return I, prior.condition_on_observations(Y=np.asarray(3.0), L=I)

    I, post = run(lgt)
    rv = I(post)
    np.testing.assert_allclose(float(rv.mean), 3.0, atol=1e-9)
    assert float(rv.std) < 1e-5
    assert post.kLas.crosscovs[0].matvec_route == "evaluate @ w"
    jI, jpost = run(jlgt)
    x = np.linspace(-1.5, 1.5, 13)
    _close(post.mean(x), jpost.mean(x), JAX_TOL)
    _close(post.std(x), jpost.std(x), JAX_TOL)


def test_lebesgue_integral_doctest_value():
    """The doctest's pushforward of a Matérn prior: std 0.9314, the JAX
    package's."""
    I = LebesgueIntegral(lgt.domains.asdomain([0.0, 1.0]))
    assert round(float(I(lgt.functions.Polynomial([0.0, 2.0]))), 6) == 1.0
    rv = I(lgt.GaussianProcess(lgt.functions.Zero(()), lgt.kernels.Matern((), nu=1.5)))
    assert round(float(rv.std), 4) == 0.9314
    jI = jlgt.functionals.LebesgueIntegral(jlgt.domains.asdomain([0.0, 1.0]))
    jrv = jI(jlgt.GaussianProcess(jlgt.functions.Zero(()), jlgt.kernels.Matern((), nu=1.5)))
    np.testing.assert_allclose(float(rv.std), float(jrv.std), rtol=1e-13)


@pytest.mark.parametrize("case", ["constant_box", "polynomial", "piecewise"])
def test_exact_integrals_of_functions(case):
    """Exact integrals of a constant on a box, and of a polynomial and a
    piecewise polynomial on an interval, against the JAX package's."""
    def make(pkg):
        f = pkg.functions
        if case == "constant_box":
            return pkg.functionals.LebesgueIntegral(pkg.domains.Box([[0.0, 5.0], [-1.0, 1.0]])), f.Constant((2,), 1.5)
        I = pkg.functionals.LebesgueIntegral(pkg.domains.Interval(-0.3, 0.8))
        if case == "polynomial":
            return I, f.Polynomial((0.5, 1.0, -2.0, 0.25))
        return I, f.Piecewise(np.asarray([-1.0, 0.0, 0.5, 1.0]),
                              [f.Polynomial((1.0, 2.0)), f.Polynomial((0.0, 0.0, 3.0)), f.Polynomial((-1.0,))])

    I, fn = make(lgt)
    jI, jfn = make(jlgt)
    np.testing.assert_allclose(float(I(fn)), float(jI(jfn)), rtol=1e-14)


def _heat_posterior(pkg):
    """The heat prior; ``H u = 0`` at 40 points of [0, 5] x [-1, 1] (noise
    1e-6), then the first sine at 8 initial points (noise 1e-8)."""
    rng0 = np.random.default_rng(0)
    X = np.stack([rng0.uniform(0.0, 5.0, 40), rng0.uniform(-1.0, 1.0, 40)], -1)
    k = pkg.kernels
    prior = pkg.GaussianProcess(
        pkg.functions.Zero((2,)),
        1.0 * k.TensorProduct(k.Matern((), nu=1.5, lengthscales=2.5), k.Matern((), nu=2.5, lengthscales=2.0)),
    )
    H = pkg.diffops.HeatOperator((2,), alpha=0.1)
    post = prior.condition_on_observations(np.zeros(40), X=X, L=H, b=pkg.Normal(np.zeros(40), 1e-6 * np.eye(40)))
    x = np.linspace(-1.0, 1.0, 8)
    post = post.condition_on_observations(np.sin(np.pi * (x + 1.0) / 2.0), X=np.stack([np.zeros(8), x], -1),
                                          b=pkg.Normal(np.zeros(8), 1e-8 * np.eye(8)))
    return prior, post, pkg.functionals.LebesgueIntegral(pkg.domains.Box([[0.0, 5.0], [-1.0, 1.0]]))


@pytest.fixture
def small_quadrature(monkeypatch):
    """Gauss-Legendre order 16 on 2 panels per axis in both packages."""
    monkeypatch.setattr(config, "quadrature_order", 16)
    monkeypatch.setattr(config, "quadrature_panels", 2)
    monkeypatch.setattr(jconfig, "quadrature_order", 16)
    monkeypatch.setattr(jconfig, "quadrature_panels", 2)


def test_box_integral_of_heat_posterior(small_quadrature):
    """The Box integral of a heat posterior (1,024 nodes) against the JAX
    package's (mean 3.49927, std 1.79751 there); then conditioning on it
    obeys the scalar Gaussian update, and the new mean matches JAX's."""
    prior, post, I = _heat_posterior(lgt)
    jprior, jpost, jI = _heat_posterior(jlgt)
    assert I.discretization().num_points == 1024
    rv, jrv = I(post), jI(jpost)
    np.testing.assert_allclose([float(rv.mean), float(rv.var)], [float(jrv.mean), float(jrv.var)], rtol=1e-10)
    np.testing.assert_allclose([float(jrv.mean), float(jrv.std)], [3.49927, 1.79751], rtol=1e-5)
    prior_var = float(I(prior).var)
    np.testing.assert_allclose(prior_var, float(jI(jprior).var), rtol=1e-12)
    assert 0.0 <= float(rv.var) <= prior_var
    y, s2 = 3.65752, 1e-10
    post2 = post.condition_on_observations(np.asarray(y), L=I, b=lgt.Normal(np.asarray(0.0), np.asarray(s2)))
    assert [c.matvec_route for c in post2.kLas] == ["K2", "K2", "K2"]
    m, v = float(rv.mean), float(rv.var)
    rv2 = I(post2)
    np.testing.assert_allclose(float(rv2.mean), m + v / (v + s2) * (y - m), rtol=0, atol=1e-8 * y)
    np.testing.assert_allclose(float(rv2.var), v * s2 / (v + s2), rtol=0, atol=1e-11 * prior_var)
    jpost2 = jpost.condition_on_observations(np.asarray(y), L=jI, b=jlgt.Normal(np.asarray(0.0), np.asarray(s2)))
    xq = np.stack([np.linspace(0.0, 5.0, 9), np.linspace(-1.0, 1.0, 9)], -1)
    _close(post2.mean(xq), jpost2.mean(xq), JAX_TOL)
    _close(post2.std(xq), jpost2.std(xq), 1e-8)
    # The K2 route of the integral block is the same function as evaluate @ w.
    w = post2.representer_weights[-1:]
    blk = post2.kLas.crosscovs[-1]
    _close(blk.matvec(_t(xq), w), (blk.evaluate(_t(xq)) @ w).numpy(), 1e-13)


def test_node_blocked_contraction_matches_unblocked(small_quadrature, monkeypatch):
    """The weighted contractions summed over blocks of nodes equal the
    one-block contraction (1e-13 of their scale): the integral's prior
    variance, its crosscov at points, and the posterior's block."""
    prior, post, I = _heat_posterior(lgt)
    xq = _t(np.stack([np.linspace(0.0, 5.0, 33), np.linspace(-1.0, 1.0, 33)], -1))
    kLa = KernelFunctionalCrossCov(prior.cov, I)

    def run():
        return (apply_functional_to_crosscov(I, kLa).matrix, kLa.evaluate(xq),
                apply_functional_to_crosscov(I, post.kLas).matrix)

    monkeypatch.setitem(crosscov_base.NODE_BLOCK_ELEMS, "cpu", 1 << 40)
    whole = run()
    assert crosscov_base._node_blocks(1024, 1024, "cpu") == [slice(0, 1024)]
    monkeypatch.setitem(crosscov_base.NODE_BLOCK_ELEMS, "cpu", 3000)
    assert len(crosscov_base._node_blocks(1024, 48, "cpu")) == 17
    for blocked, ref in zip(run(), whole):
        _close(blocked, ref.numpy(), 1e-13)


def test_exact_hooks_take_evaluate_route():
    """Wherever an exact hook applies (a scaled 1-D half-integer Matérn
    under an interval integral or a hat projection), the posterior mean's
    block takes ``evaluate @ w``; a Box integral, a non-half-integer Matérn
    or an ExpQuad takes K2 over the nodes."""
    B = lgt.functions.UnivariateLinearInterpolationBasis(np.linspace(0.0, 1.0, 6), zero_boundary=True)
    I = LebesgueIntegral(lgt.domains.Interval(0.0, 1.0))
    for nu in (0.5, 1.5, 2.5, 3.5):
        k = 0.7 * (2.0 * lgt.kernels.Matern((), nu=nu, lengthscales=0.4))
        for L in (I, B.l2_projection(), B.l2_projection(normalized=False)):
            assert KernelFunctionalCrossCov(k, L).matvec_route == "evaluate @ w"
    assert KernelFunctionalCrossCov(lgt.kernels.ExpQuad((), lengthscales=0.4), I).matvec_route == "K2"
    k2 = lgt.kernels.TensorProduct(lgt.kernels.Matern((), nu=1.5), lgt.kernels.Matern((), nu=2.5))
    box = LebesgueIntegral(lgt.domains.Box([[0.0, 1.0], [-1.0, 1.0]]))
    assert KernelFunctionalCrossCov(k2, box).matvec_route == "K2"
