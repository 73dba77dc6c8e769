"""The port's FEM path (hat basis, L2 projections, weak forms, GP-FEM
conditioning, parametric GPs) against the JAX package.

Ports of ``tests/test_fem_galerkin.py`` (float64 on the CPU, through the
kernels' plain versions): each test keeps the JAX original's check and
holds the port to the JAX result on the same inputs.  Exact closed forms
(the hat-projection crosscov, the double-projection Gram) are held to the
JAX package within 1e-12 of their largest entry; assembled operators
(mass, stiffness, projections) within 1e-13; posteriors within
``JAX_TOL`` (1e-10) of their largest value.  Also: which route each block
takes, and the 1,023-element GP-FEM, where the JAX package's posterior is
NaN, raises ``LinAlgError`` or gives finite values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate as si
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu.ops.crosscov.base import KernelFunctionalCrossCov as JKernelFunctionalCrossCov
from linpde_gp_tpu.ops.crosscov.base import apply_functional_to_crosscov as japply_functional_to_crosscov
from linpde_gp_tpu.ops.transforms import integrals_exact as jie
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.crosscov.base import (
    KernelFunctionalCrossCov,
    apply_functional_to_crosscov,
    evaluate_crosscov_contraction,
)
from linpde_gp_tpu_torch.ops.functionals import (
    BasisIntegralFunctional,
    L2Projection_UnivariateLinearInterpolationBasis,
    fem_mass_matrix,
)
from linpde_gp_tpu_torch.ops.transforms import integrals_exact as ie

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

#: Port vs the JAX package on the same inputs, relative to the values' scale.
JAX_TOL = 1e-10


def _close(port, ref, tol):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * max(np.max(np.abs(ref)), 1e-300))


def make_bases(pkg, num_elements=5, domain=(-1.0, 1.0)):
    grid = np.linspace(domain[0], domain[1], num_elements + 2)
    B = pkg.functions.UnivariateLinearInterpolationBasis
    return B(grid, zero_boundary=False), B(grid, zero_boundary=True)


def test_hat_basis_partition_of_unity():
    trial, _ = make_bases(lgt)
    jtrial, jtest = make_bases(jlgt)
    x = np.linspace(-1, 1, 101)
    vals = trial(x).numpy()
    np.testing.assert_allclose(vals.sum(axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(trial(torch.from_numpy(trial.x_i)).numpy(), np.eye(len(trial)), atol=1e-12)
    np.testing.assert_array_equal(vals, np.asarray(jtrial(jnp.asarray(x))))
    _, test = make_bases(lgt)
    np.testing.assert_array_equal(test(x).numpy(), np.asarray(jtest(jnp.asarray(x))))
    for basis, jbasis in ((trial, jtrial), (test, jtest)):
        np.testing.assert_array_equal(basis.grid, jbasis.grid)
        for idx in (0, 2, -1):
            np.testing.assert_array_equal(basis.eval_elem(idx, x).numpy(), np.asarray(jbasis.eval_elem(idx, x)))
            assert basis.support_bounds(idx) == jbasis.support_bounds(idx)


def test_mass_matrix_against_quadrature():
    trial, _ = make_bases(lgt, 4)
    M = fem_mass_matrix(trial)
    x = np.linspace(trial.grid[0], trial.grid[-1], 20001)
    phi = trial(x).numpy()
    # The boundary hats jump to zero at the domain's edge: the trapezoid
    # oracle carries an O(h) error there.
    M_quad = np.trapezoid(phi[:, :, None] * phi[:, None, :], x, axis=0)
    np.testing.assert_allclose(M, M_quad, atol=1.5e-4)
    np.testing.assert_array_equal(M, jlgt.ops.functionals.fem_mass_matrix(make_bases(jlgt, 4)[0]))


def test_l2_projection_of_polynomial():
    trial, _ = make_bases(lgt, 6)
    proj = L2Projection_UnivariateLinearInterpolationBasis(trial)
    coeffs = proj(lgt.functions.Polynomial((0.5, 1.0, -2.0))).numpy()
    # The projection minimizes the L2 error: the residual is orthogonal to
    # every basis function.
    x = np.linspace(-1, 1, 20001)
    phi = trial(x).numpy()
    resid = (0.5 + x - 2.0 * x**2) - phi @ coeffs
    np.testing.assert_allclose(np.trapezoid(phi * resid[:, None], x, axis=0), 0.0, atol=1e-6)
    jproj = jlgt.ops.functionals.L2Projection_UnivariateLinearInterpolationBasis(make_bases(jlgt, 6)[0])
    _close(coeffs, jproj(jlgt.functions.Polynomial((0.5, 1.0, -2.0))), 1e-13)
    _close(proj.normalizer, jproj.normalizer, 1e-13)
    disc, jdisc = proj.discretization(), jproj.discretization()
    np.testing.assert_array_equal(disc.points.numpy(), np.asarray(jdisc.points))
    _close(disc.weights, jdisc.weights, 1e-13)


def test_weak_form_stiffness_matrix():
    trial, test = make_bases(lgt, 5)
    A = lgt.diffops.Laplacian(()).weak_form(test)(trial).todense()
    assert A.shape == (len(test), len(trial))
    # Against -int phi' psi' by quadrature.
    x = np.linspace(trial.grid[1], trial.grid[-2], 40001)
    h = x[1] - x[0]
    dphi = np.gradient(test(x).numpy(), h, axis=0)
    dpsi = np.gradient(trial(x).numpy(), h, axis=0)
    A_quad = -np.trapezoid(dphi[:, :, None] * dpsi[:, None, :], x, axis=0)
    np.testing.assert_allclose(A.numpy(), A_quad, atol=1e-3)
    jtrial, jtest = make_bases(jlgt, 5)
    _close(A, jlgt.diffops.Laplacian(()).weak_form(jtest)(jtrial).todense(), 1e-13)


def test_scaled_diffop_weak_form():
    trial, test = make_bases(lgt, 5)
    A = (-2.5 * lgt.diffops.Laplacian(())).weak_form(test)(trial).todense().numpy()
    A_base = lgt.diffops.Laplacian(()).weak_form(test)(trial).todense().numpy()
    np.testing.assert_allclose(A, -2.5 * A_base, atol=1e-12)
    jtrial, jtest = make_bases(jlgt, 5)
    _close(A, (-2.5 * jlgt.diffops.Laplacian(())).weak_form(jtest)(jtrial).todense(), 1e-13)
    with pytest.raises(NotImplementedError):
        lgt.diffops.Derivative(1).weak_form(test)


def _gp_fem(pkg, num_elements=5, noise=None):
    """The reference notebook's GP-FEM flow (``experiments/poisson_fem.py``):
    ``(bvp, trial, trial_proj, A, rhs, Y_bc, post)``."""
    bvp = pkg.problems.PoissonEquationDirichletProblem(
        domain=pkg.domains.asdomain([-1.0, 1.0]), rhs=pkg.functions.Constant((), 2.0), boundary_values=(0.0, 1.0)
    )
    trial, test = make_bases(pkg, num_elements)
    trial_proj = trial.l2_projection()
    A = bvp.pde.diffop.weak_form(test)(trial)
    rhs = np.asarray(test.l2_projection(normalized=False)(bvp.pde.rhs))
    prior = pkg.GaussianProcess(pkg.functions.Zero(()), 1.0 * pkg.kernels.Matern((), nu=1.5, lengthscales=1.0))
    X_bc, Y_bc = pkg.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)
    X_bc, Y_bc = np.asarray(X_bc), np.asarray(Y_bc)

    def b(n):
        return None if noise is None else pkg.Normal(np.zeros(n), noise * np.eye(n))

    post = prior.condition_on_observations(Y_bc, X=X_bc, b=b(2))
    post = post.condition_on_observations(rhs, L=A @ trial_proj, b=b(len(rhs)))
    return bvp, trial, trial_proj, A, rhs, Y_bc, post


def test_gp_fem_galerkin_conditioning():
    """The GP-FEM flow of the reference notebook, with the projected belief
    as a parametric GP, against the JAX package."""
    bvp, trial, trial_proj, A, rhs, _, post = _gp_fem(lgt)
    assert rhs.shape == (5,)
    grid = np.linspace(-1, 1, 41)
    mean, std = post.mean(grid).numpy(), post.std(grid).numpy()
    sol = bvp.solution(torch.from_numpy(grid)).numpy()
    assert np.all(np.isfinite(mean))
    # FEM with 5 elements: coarse, but it must track the solution.
    assert np.max(np.abs(mean - sol)) < 0.25
    # The Galerkin block's crosscov is the exact projection: evaluate @ w.
    assert [c.matvec_route for c in post.kLas] == ["K2", "evaluate @ w"]
    Pu = trial_proj(post)
    assert isinstance(Pu, lgt.Normal)
    pu_gp = lgt.models.ParametricGaussianProcess(weights=Pu, feature_fn=trial)
    vals, pstd = pu_gp.mean(grid).numpy(), pu_gp.std(grid).numpy()
    assert np.all(np.isfinite(vals)) and np.all(np.isfinite(pstd))
    assert np.max(np.abs(vals - mean)) < 0.25

    _, jtrial, jtrial_proj, jA, jrhs, _, jpost = _gp_fem(jlgt)
    _close(A.todense(), jA.todense(), 1e-13)
    _close(rhs, jrhs, 1e-13)
    _close(mean, jpost.mean(grid), JAX_TOL)
    _close(std, jpost.std(grid), JAX_TOL)
    jPu = jtrial_proj(jpost)
    _close(Pu.mean, jPu.mean, JAX_TOL)
    _close(Pu.cov.matrix, jPu.cov.matrix, JAX_TOL)
    jpu_gp = jlgt.models.ParametricGaussianProcess(weights=jPu, feature_fn=jtrial)
    _close(vals, jpu_gp.mean(grid), JAX_TOL)
    _close(pstd, jpu_gp.std(grid), JAX_TOL)


def test_gp_fem_1023_elements_raises_or_is_finite():
    """At 1,023 elements the Galerkin Gram is indefinite in float64 (the
    projection crosscov's differences cancel; ROADMAP Queue 3) and the JAX
    package's posterior mean is NaN.  The port raises ``LinAlgError`` after
    its jitter ladder, or returns finite values: never a NaN."""
    x = np.linspace(-1, 1, 64)
    try:
        post = _gp_fem(lgt, 1023)[-1]
        mean, std = post.mean(x), post.std(x)
    except torch.linalg.LinAlgError:
        return
    assert torch.isfinite(mean).all() and torch.isfinite(std).all()


def _hat_pair(pkg, zero_boundary):
    return pkg.functions.UnivariateLinearInterpolationBasis(np.linspace(-1.0, 1.0, 6), zero_boundary=zero_boundary)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("zero_boundary", [False, True])
def test_exact_matern_hat_projection_crosscov(nu, zero_boundary):
    """The closed-form hat-basis projection crosscov against the JAX
    package's (1e-12) and, on one point, against scipy's adaptive
    quadrature of the hat times the kernel (the JAX test's oracle, 1e-11)."""
    basis, jbasis = _hat_pair(lgt, zero_boundary), _hat_pair(jlgt, zero_boundary)
    k = 1.7 * lgt.kernels.Matern((), nu=nu, lengthscales=0.43)
    jk = 1.7 * jlgt.kernels.Matern((), nu=nu, lengthscales=0.43)
    x = np.asarray([-0.9, 0.05, 1.3])
    proj = L2Projection_UnivariateLinearInterpolationBasis(basis)
    jproj = jlgt.ops.functionals.L2Projection_UnivariateLinearInterpolationBasis(jbasis)
    got = ie.exact_projection_crosscov(k, proj)(torch.from_numpy(x)).numpy()
    _close(got, jie.exact_projection_crosscov(jk, jproj)(jnp.asarray(x)), 1e-12)
    raw = ie.exact_projection_crosscov(k, BasisIntegralFunctional(basis))(torch.from_numpy(x)).numpy()
    jraw = jie.exact_projection_crosscov(jk, jlgt.ops.functionals.BasisIntegralFunctional(jbasis))(jnp.asarray(x))
    _close(raw, jraw, 1e-12)
    load = np.zeros(len(basis))
    for i in range(len(basis)):
        lo, hi = basis.support_bounds(i)
        load[i] = si.quad(lambda t: float(basis.eval_elem(i, t)) * 1.7
                          * float(k.covfunc(torch.tensor(0.05, dtype=torch.float64), torch.tensor(t))),
                          lo, hi, limit=200, epsabs=1e-13, epsrel=1e-13)[0]
    np.testing.assert_allclose(raw[1], load, atol=1e-11)
    np.testing.assert_allclose(got[1], load @ proj.normalizer.numpy().T, atol=1e-11)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("zb", [(True, True), (False, True), (False, False)])
def test_exact_matern_hat_double_projection_gram(nu, zb):
    """The closed-form hat x hat double-projection Gram against the JAX
    package's (1e-12 of its largest entry), on two different grids, and its
    transpose against the swapped call."""
    zb1, zb2 = zb
    B, jB = lgt.functions.UnivariateLinearInterpolationBasis, jlgt.functions.UnivariateLinearInterpolationBasis
    g1, g2 = np.linspace(-1.0, 1.0, 5), np.linspace(-0.8, 1.2, 6)
    G = ie.matern_hat_double_projection_gram(nu, 0.37, B(g1, zb1), B(g2, zb2))
    assert G.dtype == torch.float64 and G.shape == (len(B(g1, zb1)), len(B(g2, zb2)))
    _close(G, jie.matern_hat_double_projection_gram(nu, 0.37, jB(g1, zb1), jB(g2, zb2)), 1e-12)
    GT = ie.matern_hat_double_projection_gram(nu, 0.37, B(g2, zb2), B(g1, zb1))
    _close(GT.T, G.numpy(), 1e-12)


def test_double_projection_gram_row_blocks(monkeypatch):
    """The Gram formed a few output rows at a time is the one-block Gram."""
    B = lgt.functions.UnivariateLinearInterpolationBasis
    b1, b2 = B(np.linspace(0.0, 1.0, 12), True), B(np.linspace(-0.2, 1.1, 9), False)
    whole = ie.matern_hat_double_projection_gram(2.5, 0.3, b1, b2)
    monkeypatch.setattr(ie, "_PAIR_BLOCK_ELEMS", 4 * len(b2) * 3)
    np.testing.assert_array_equal(ie.matern_hat_double_projection_gram(2.5, 0.3, b1, b2).numpy(), whole.numpy())


def test_exact_projection_used_in_conditioning_path():
    """Conditioning on L2-projected observations takes the exact crosscov
    (a scalar 1-D Matérn prior), the mean's block takes ``evaluate @ w``, and
    the posterior matches the JAX package's."""
    def run(pkg, fn):
        basis = pkg.functions.UnivariateLinearInterpolationBasis(np.linspace(0.0, 1.0, 7), zero_boundary=True)
        proj = basis.l2_projection()
        k = pkg.kernels.Matern((), nu=1.5, lengthscales=0.3)
        prior = pkg.GaussianProcess(pkg.functions.Zero(()), k)
        rhs = np.asarray(proj.apply_to_function(pkg.functions.LambdaFunction(lambda t: fn(2 * t), (), ()))).reshape(-1)
        return k, proj, prior.condition_on_observations(rhs, L=proj)

    x = np.linspace(0, 1, 11)
    k, proj, post = run(lgt, torch.sin)
    vals = evaluate_crosscov_contraction(k, proj, 1, torch.from_numpy(x))
    assert vals.shape == (11, len(proj.basis))
    assert post.kLas.crosscovs[0].matvec_route == "evaluate @ w"
    mean, std = post.mean(x), post.std(x)
    assert torch.isfinite(mean).all() and torch.isfinite(std).all()
    jk, jproj, jpost = run(jlgt, jnp.sin)
    from linpde_gp_tpu.ops.crosscov.base import evaluate_crosscov_contraction as jevaluate

    _close(vals, jevaluate(jk, jproj, 1, jnp.asarray(x)), 1e-12)
    _close(mean, jpost.mean(x), JAX_TOL)
    _close(std, jpost.std(x), JAX_TOL)


def test_exact_double_projection_routed_in_gram_block():
    """``apply_functional_to_crosscov`` takes the exact Gram for L2-projection
    pairs (normalizers included); it agrees with the Gauss-Legendre
    contraction of the exact crosscov and with the JAX package."""
    def make(pkg):
        basis = pkg.functions.UnivariateLinearInterpolationBasis(np.linspace(0.0, 1.0, 7), zero_boundary=True)
        return basis.l2_projection(), 1.3 * pkg.kernels.Matern((), nu=2.5, lengthscales=0.3)

    proj, k = make(lgt)
    cc = KernelFunctionalCrossCov(k, proj, argnum=1)
    blk = ie.exact_projection_gram(proj, cc)
    assert blk is not None
    got = apply_functional_to_crosscov(proj, cc).matrix
    np.testing.assert_allclose(got.numpy(), blk.numpy(), atol=1e-14)
    disc = proj.discretization()
    np.testing.assert_allclose(got.numpy(), (disc.weights @ cc.evaluate(disc.points)).numpy(), atol=1e-9)
    np.testing.assert_allclose(got.numpy(), got.numpy().T, atol=1e-14)
    jproj, jk = make(jlgt)
    _close(got, japply_functional_to_crosscov(jproj, JKernelFunctionalCrossCov(jk, jproj, argnum=1)).matrix, 1e-12)
