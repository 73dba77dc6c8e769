"""Domains, functions and PDE problems of the PyTorch port against the JAX
package (float64 on the CPU), and the ports of ``tests/test_problems.py``.

- Domains: ``uniform_grid`` (and its factors), ``boundary``, ``asdomain``,
  indexing and equality, against JAX's on the same arguments (exact).
- Every ported function and the problems' analytic solutions at seeded
  points, against JAX's (within 1e-13 of the values' scale).
- Each case of ``tests/test_problems.py``, through the port's dense engine
  with the JAX test's own gates.  None needs item 9b (operators applied to
  functions other than ``Zero``) or 9c (FEM): the right-hand sides are only
  evaluated at the collocation points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

TOL = 1e-13


def _close(port, ref, tol=TOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0))


# -- domains -----------------------------------------------------------------------


def _domain_cases(pkg):
    d = pkg.domains
    return {
        "interval": d.asdomain([-1.0, 2.0]),
        "box": d.Box([[0.0, 5.0], [-1.0, 1.0]]),
        "degenerate_box": d.Box([[0.0, 0.0], [-1.0, 1.0]]),
        "product": d.CartesianProduct(d.Interval(0.0, 5.0), d.Point(1.0)),
    }


@pytest.mark.parametrize("case", ["interval", "box", "degenerate_box", "product"])
@pytest.mark.parametrize("kw", [{}, {"inset": 1e-3}, {"centered": True}])
def test_uniform_grid_matches_jax(case, kw):
    port, ref = _domain_cases(lgt)[case], _domain_cases(jlgt)[case]
    assert port.shape == ref.shape and port.dimension == ref.dimension
    shape = (5, 4) if case == "box" else (7,)
    g, gj = port.uniform_grid(shape, **kw), ref.uniform_grid(shape, **kw)
    np.testing.assert_array_equal(np.asarray(g), np.asarray(gj))
    if case == "interval":
        assert type(g) is np.ndarray
    else:
        assert isinstance(g, lgt.domains.TensorProductGrid)
        assert len(g.factors) == len(gj.factors)
        for f, fj in zip(g.factors, gj.factors):
            np.testing.assert_array_equal(f, fj)


def test_domain_boundaries_volume_and_equality():
    d, jd = lgt.domains, jlgt.domains
    box, jbox = d.Box([[0.0, 5.0], [-1.0, 1.0]]), jd.Box([[0.0, 5.0], [-1.0, 1.0]])
    assert repr(box) == repr(jbox) and float(box.volume) == float(jbox.volume) == 10.0
    assert [repr(b) for b in box.boundary] == [repr(b) for b in jbox.boundary]
    assert len(box.boundary) == 4 and box.boundary[0] == d.CartesianProduct(d.Point(0.0), d.Interval(-1.0, 1.0))
    assert box[1] == d.Interval(-1.0, 1.0) and box[0:1] == d.Box([[0.0, 5.0]])
    assert np.asarray([1.0, 0.0]) in box and np.asarray([6.0, 0.0]) not in box
    iv = d.asdomain([-1.0, 1.0])
    assert iv == d.Interval(-1.0, 1.0) and iv != d.Interval(-1.0, 2.0) and hash(iv) == hash(d.Interval(-1.0, 1.0))
    assert tuple(iv) == (-1.0, 1.0) and iv.boundary == (d.Point(-1.0), d.Point(1.0))
    assert 0.5 in iv and 2.0 not in iv
    assert d.asdomain(3.0) == d.Point(3.0) and float(d.Point(3.0)) == 3.0
    assert d.asdomain(np.asarray([[0.0, 1.0], [2.0, 3.0]])) == d.Box([[0.0, 1.0], [2.0, 3.0]])
    assert d.asdomain(np.asarray([0.0, 1.0])) == d.Interval(0.0, 1.0)
    with pytest.raises(TypeError):
        d.asdomain(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        d.Interval(1.0, 0.0)


def test_tensor_product_grid_survives_slicing():
    g = lgt.domains.Box([[0.0, 1.0], [0.0, 2.0]]).uniform_grid((3, 4))
    assert lgt.domains.grid_factors(g[..., 0]) is not None  # a view keeps the factors
    assert lgt.domains.grid_factors(np.asarray(g)) is None


# -- functions ---------------------------------------------------------------------


def _function_cases(pkg, xp):
    F = pkg.functions
    sd = pkg.domains.asdomain([-1.0, 2.0])
    sine = F.TruncatedSineSeries(sd, coefficients=[1.0, -0.5, 0.25])
    poly = F.Polynomial((0.5, -1.0, 2.0))
    return {
        "constant": ((), F.Constant((), 2.5)),
        "constant_vector_in": ((3,), F.Constant((3,), -1.5)),
        "affine_scalar": ((), F.Affine(2.0, 0.5)),
        "affine_vector": ((3,), F.Affine(np.asarray([1.0, -2.0, 0.5]), 0.25)),
        "affine_matrix": ((3,), F.Affine(np.arange(6.0).reshape(2, 3), np.asarray([1.0, -1.0]))),
        "piecewise": ((), F.Piecewise(np.asarray([-1.0, 0.0, 0.5, 2.0]), [poly, F.Constant((), 1.0), F.Polynomial((0.0, 3.0))])),
        "piecewise_linear": ((), F.PiecewiseLinear.from_points(np.asarray([-1.0, 0.0, 2.0]), np.asarray([1.0, -1.0, 0.5]))),
        "piecewise_constant": ((), F.PiecewiseConstant(np.asarray([-1.0, 0.5, 2.0]), np.asarray([3.0, -2.0]))),
        "sine_series": ((), sine),
        "gmm_pdf": ((), F.TruncatedGaussianMixturePDF(sd, means=[0.0, 1.0], stds=[0.3, 0.5], weights=[0.4, 0.6])),
        "stack": ((), F.stack([sine, poly, F.Monomial(3)])),
        "monomial": ((), F.Monomial(4)),
        "lambda": ((), F.LambdaFunction(lambda x: xp.sin(3.0 * x) * x, ())),
        "lambda_pointwise": ((2,), F.LambdaFunction(lambda x: x[0] * x[1] - x[1], (2,), vectorized=False)),
        "sum": ((), sine + poly),
        "scalar_arithmetic": ((), 2.0 * (sine - 0.5) / 4.0 + 1.0),
        "negation": ((), -sine - F.Constant((), 1.0)),
        "product": ((), F.ProductFunction(sine, poly)),
        "asfunction": ((), F.asfunction(0.75) + F.asfunction(lambda x: x * x, ())),
        "piecewise_plus_polynomial": ((), F.PiecewiseLinear.from_points([-1.0, 0.0, 2.0], [1.0, -1.0, 0.5]) + poly),
        "polynomial_times_monomial": ((), poly * F.Monomial(2)),
    }


@pytest.mark.parametrize("case", list(_function_cases(jlgt, jnp)))
def test_function_matches_jax(case):
    shape, port = _function_cases(lgt, torch)[case]
    _, ref = _function_cases(jlgt, jnp)[case]
    assert port.input_shape == ref.input_shape and port.output_shape == ref.output_shape
    x = np.random.default_rng(4).uniform(-1.5, 2.5, (5, 3) + shape)
    x.reshape(-1)[:3] = [-1.0, 0.5, 2.0]  # partition and truncation points
    y = port(torch.from_numpy(x))
    assert y.dtype == torch.float64 and y.shape == (5, 3) + port.output_shape
    _close(y, ref(jnp.asarray(x)))


def test_zero_absorbs_arithmetic():
    F = lgt.functions
    z = F.Zero(())
    f = F.TruncatedSineSeries([-1.0, 1.0], [1.0])
    assert 3.0 * z is z and z * 2.0 is z and f + z is f and z + f is f


def test_python_scalars_evaluate_in_float64():
    """A Python float or list is evaluated in float64, as JAX evaluates it
    in 64-bit mode (``torch.as_tensor`` alone made it float32)."""
    F = lgt.functions
    assert F.Monomial(1)(0.5).dtype == torch.float64 and F.Polynomial((1.0, 2.0))([0.1, 0.2]).dtype == torch.float64
    p = F.Polynomial((0.0, 1.0))
    assert float(p(0.1)) == 0.1 and float(F.Constant((), 2.0)(0.5)) == 2.0


# -- problems and their solutions --------------------------------------------------


def _problems(pkg):
    F, P, D = pkg.functions, pkg.problems, pkg.domains
    sd = D.asdomain([-1.0, 1.0])
    return {
        "heat": P.HeatEquationDirichletProblem(
            t0=0.0, T=5.0, spatial_domain=sd, alpha=0.1,
            initial_values=F.TruncatedSineSeries(sd, coefficients=[1.0, 0.3]),
        ),
        "poisson_const": P.PoissonEquationDirichletProblem(
            domain=D.asdomain([-1.0, 2.0]), rhs=F.Constant((), 2.0), boundary_values=(0.5, 1.0), alpha=1.5
        ),
        "poisson_ivp_poly": P.Solution_PoissonEquation_IVP_1D_RHSPolynomial(
            (0.0, 1.0), rhs=F.Polynomial((1.0, 2.0, 0.5)), initial_values=(0.3, -0.2), alpha=2.0
        ),
        "poisson_ivp_piecewise": P.Solution_PoissonEquation_IVP_1D_RHSPiecewisePolynomial(
            (0.0, 2.0), rhs=F.Piecewise([0.0, 0.7, 2.0], [F.Polynomial((1.0, -1.0)), F.Polynomial((0.5, 0.0, 1.0))]),
            initial_values=(0.1, 0.4), alpha=1.0,
        ),
    }


@pytest.mark.parametrize("case", ["heat", "poisson_const", "poisson_ivp_poly", "poisson_ivp_piecewise"])
def test_solution_matches_jax(case):
    port, ref = _problems(lgt)[case], _problems(jlgt)[case]
    port_sol = getattr(port, "solution", port)
    ref_sol = getattr(ref, "solution", ref)
    assert port_sol is not None and type(port_sol).__name__ == type(ref_sol).__name__
    rng = np.random.default_rng(5)
    if case == "heat":
        x = np.stack([rng.uniform(0.0, 5.0, 50), rng.uniform(-1.0, 1.0, 50)], -1)
    else:
        x = rng.uniform(0.0, 2.0, 50)
    _close(port_sol(torch.from_numpy(x)), ref_sol(jnp.asarray(x)))


def test_heat_problem_structure_matches_jax():
    port, ref = _problems(lgt)["heat"], _problems(jlgt)["heat"]
    assert repr(port.domain) == repr(ref.domain) and repr(port.initial_domain) == repr(ref.initial_domain)
    assert (port.t0, port.T) == (ref.t0, ref.T) == (0.0, 5.0)
    assert [repr(bc.boundary) for bc in port.boundary_conditions] == [repr(bc.boundary) for bc in ref.boundary_conditions]
    assert port.pde.diffop.input_domain_shape == (2,)
    X = np.asarray(port.domain.uniform_grid((6, 5))).reshape(-1, 2)
    _close(port.pde.rhs(torch.from_numpy(X)), ref.pde.rhs(jnp.asarray(X)))
    for bc, jbc in zip(port.boundary_conditions, ref.boundary_conditions):
        Xb = np.asarray(bc.boundary.uniform_grid(7))
        _close(bc.values(torch.from_numpy(Xb)), jbc.values(jnp.asarray(Xb)))
    x_ic = np.linspace(-1.0, 1.0, 9)
    _close(port.initial_condition.values(torch.from_numpy(x_ic)), ref.initial_condition.values(jnp.asarray(x_ic)))


def test_dirichlet_boundary_observations_match_jax():
    port, ref = _problems(lgt)["poisson_const"], _problems(jlgt)["poisson_const"]
    X, Y = lgt.problems.get_1d_dirichlet_boundary_observations(port.boundary_conditions)
    Xj, Yj = jlgt.problems.get_1d_dirichlet_boundary_observations(ref.boundary_conditions)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(Y, Yj)


# -- tests/test_problems.py through the port's dense engine -------------------------


def test_poisson_1d_dirichlet_converges_to_analytic():
    bvp = lgt.problems.PoissonEquationDirichletProblem(
        domain=lgt.domains.asdomain([-1.0, 1.0]), rhs=lgt.functions.Constant((), 2.0), boundary_values=(0.0, 1.0)
    )
    assert bvp.solution is not None
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), 2.0**2 * lgt.kernels.ExpQuad((), lengthscales=1.0))
    X_pde = bvp.domain.uniform_grid((20,))
    X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)
    post = prior.condition_on_observations(bvp.pde.rhs(X_pde), X=X_pde, L=bvp.pde.diffop).condition_on_observations(
        Y_bc, X=X_bc
    )
    grid = np.linspace(-1, 1, 101)
    err = np.max(np.abs(post.mean(grid).numpy() - bvp.solution(grid).numpy()))
    assert err < 1e-6
    assert np.all(np.isfinite(post.std(grid).numpy()))


def test_poisson_1d_sine_rhs():
    f = lgt.functions.LambdaFunction(lambda x: torch.pi**2 * torch.sin(torch.pi * x), ())
    sol = lgt.functions.LambdaFunction(lambda x: torch.sin(torch.pi * x), ())
    bvp = lgt.problems.PoissonEquationDirichletProblem(domain=[-1.0, 1.0], rhs=f, boundary_values=np.zeros(2), solution=sol)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), 2.0**2 * lgt.kernels.ExpQuad((), lengthscales=1.0))
    X_pde = bvp.domain.uniform_grid((25,))
    X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)
    post = prior.condition_on_observations(bvp.pde.rhs(X_pde), X=X_pde, L=bvp.pde.diffop).condition_on_observations(
        Y_bc, X=X_bc
    )
    grid = np.linspace(-1, 1, 101)
    err = np.max(np.abs(post.mean(grid).numpy() - bvp.solution(grid).numpy()))
    assert err < 1e-5


def test_heat_1d_matches_sine_series_solution():
    spatial_domain = lgt.domains.asdomain([-1.0, 1.0])
    ibvp = lgt.problems.HeatEquationDirichletProblem(
        t0=0.0, T=5.0, spatial_domain=spatial_domain, alpha=0.1,
        initial_values=lgt.functions.TruncatedSineSeries(spatial_domain, coefficients=[1.0]),
    )
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5), lgt.kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )
    X_ic = ibvp.initial_domain.uniform_grid(5, inset=1e-6)
    Y_ic = ibvp.initial_condition.values(X_ic[..., 1])
    post = prior.condition_on_observations(Y_ic, X=np.asarray(X_ic))
    for bc in ibvp.boundary_conditions:
        X_bc = bc.boundary.uniform_grid(25)
        post = post.condition_on_observations(bc.values(X_bc), X=np.asarray(X_bc))
    X_pde = ibvp.domain.uniform_grid((40, 15))
    post = post.condition_on_observations(ibvp.pde.rhs(X_pde), X=np.asarray(X_pde), L=ibvp.pde.diffop)
    plt_grid = np.asarray(ibvp.domain.uniform_grid((30, 20))).reshape(-1, 2)
    mean = post.mean(plt_grid).numpy()
    sol = ibvp.solution(plt_grid).numpy()
    err = np.mean(np.abs(mean - sol))
    assert err < 3e-2, err
    std = post.std(plt_grid).numpy()
    assert np.all(np.abs(mean - sol) <= 2 * std + 3e-2)


def _poisson_2d(kernel):
    bvp = lgt.problems.PoissonEquationDirichletProblem(
        domain=lgt.domains.Box([[-1.0, 1.0], [-1.0, 1.0]]),
        rhs=lgt.functions.Constant((2,), 2.0),
        boundary_values=lgt.functions.Constant((2,), 0.0),
    )
    k = lgt.kernels
    prior = lgt.GaussianProcess(lgt.functions.Zero((2,)), 2.0**2 * k.TensorProduct(kernel(k), kernel(k)))
    return bvp, prior


def test_poisson_2d_product_matern():
    bvp, post = _poisson_2d(lambda k: k.Matern((), nu=2.5, lengthscales=1.0))
    for bc in bvp.boundary_conditions:
        X_bc = bc.boundary.uniform_grid(8, inset=1e-6)
        Y_bc = bc.values(np.asarray(X_bc))
        post = post.condition_on_observations(Y_bc.reshape(-1), X=np.asarray(X_bc).reshape(-1, 2))
    X_pde = bvp.domain.uniform_grid((8, 8))
    Y_pde = bvp.pde.rhs(X_pde)
    post = post.condition_on_observations(Y_pde.reshape(-1), X=np.asarray(X_pde).reshape(-1, 2), L=bvp.pde.diffop)
    grid = np.asarray(bvp.domain.uniform_grid((12, 12))).reshape(-1, 2)
    assert torch.isfinite(post.mean(grid)).all()
    # The PDE holds exactly at the collocation points (noiseless
    # conditioning): the operator posterior's mean interpolates the RHS.
    resid = bvp.pde.diffop(post).mean(np.asarray(X_pde).reshape(-1, 2)).numpy() - 2.0
    assert np.max(np.abs(resid)) < 1e-8, np.max(np.abs(resid))


def test_poisson_2d_expquad_converges_to_truth():
    bvp, post = _poisson_2d(lambda k: k.ExpQuad((), lengthscales=1.0))
    for bc in bvp.boundary_conditions:
        X_bc = bc.boundary.uniform_grid(10, inset=1e-6)
        post = post.condition_on_observations(
            bc.values(np.asarray(X_bc)).reshape(-1), X=np.asarray(X_bc).reshape(-1, 2)
        )
    X_pde = bvp.domain.uniform_grid((10, 10))
    post = post.condition_on_observations(np.full(100, 2.0), X=np.asarray(X_pde).reshape(-1, 2), L=bvp.pde.diffop)
    # Truth at the center from the double sine series of -lap u = 2.
    truth = 0.5893706973679599
    assert abs(float(post.mean(np.zeros(2))) - truth) < 1e-2


def test_poisson_ivp_polynomial_solution_oracle():
    rhs = lgt.functions.Polynomial((1.0, 2.0, 0.5))
    sol = lgt.problems.Solution_PoissonEquation_IVP_1D_RHSPolynomial(
        (0.0, 1.0), rhs=rhs, initial_values=(0.3, -0.2), alpha=2.0
    )
    xs = torch.linspace(0, 1, 9, dtype=torch.float64)
    upp = sol.differentiate().differentiate()
    np.testing.assert_allclose(-2.0 * upp(xs).numpy(), rhs(xs).numpy(), atol=1e-12)
    np.testing.assert_allclose(float(sol(torch.tensor(0.0))), 0.3, atol=1e-12)
    np.testing.assert_allclose(float(sol.differentiate()(torch.tensor(0.0))), -0.2, atol=1e-12)
