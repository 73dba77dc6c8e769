"""Mixed-precision iterative refinement in the port (``ops/linalg/refine.py``).

Ports of the three tests of ``tests/test_refine.py``: a float32 factor
plus float64 preconditioned-CG refinement, on the CPU, against the float64
direct solve, the analytic Poisson solution, the port's own float64
posterior and the JAX package's refined posterior on the same inputs.
The Poisson-1D Dirichlet data come from the JAX package's problem
definition (``PoissonEquationDirichletProblem``; the port's comes with
ROADMAP item 9d) as numpy arrays.
"""

import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu.config import config as jconfig
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.linalg.refine import refined_solve

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


def _poisson_data():
    bvp = jlgt.problems.PoissonEquationDirichletProblem(
        domain=jlgt.domains.asdomain([-1.0, 1.0]),
        rhs=jlgt.functions.Constant((), 2.0),
        boundary_values=(0.0, 1.0),
    )
    X_pde = np.asarray(bvp.domain.uniform_grid((20,), inset=0.0))
    Y_pde = np.asarray(bvp.pde.rhs(X_pde))
    X_bc, Y_bc = (np.asarray(a) for a in jlgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions))
    return bvp, X_pde, Y_pde, X_bc, Y_bc


def _poisson_posterior(pkg, dops):
    _, X_pde, Y_pde, X_bc, Y_bc = _poisson_data()
    prior = pkg.GaussianProcess(pkg.functions.Zero(()), 2.0**2 * pkg.kernels.ExpQuad((), lengthscales=1.0))
    post = prior.condition_on_observations(Y_pde, X=X_pde, L=-1.0 * dops.Laplacian(()))
    return post.condition_on_observations(Y_bc, X=X_bc)


@pytest.fixture
def refinement():
    config.set(solve_refinement=True)
    jconfig.set(solve_refinement=True)
    yield
    config.set(solve_refinement=False)
    jconfig.set(solve_refinement=False)


def test_refined_solve_matches_direct():
    """On a well-conditioned SPD system the refined solve reproduces the
    float64 direct solution to round-off, per column of a block and for a
    vector."""
    rng = np.random.default_rng(0)
    A0 = rng.standard_normal((40, 40))
    gram = torch.as_tensor(A0 @ A0.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal((40, 3)))
    chol32 = torch.linalg.cholesky(gram.float())
    x_ref = torch.linalg.solve(gram, b).numpy()
    np.testing.assert_allclose(refined_solve(gram, chol32, b).numpy(), x_ref, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(refined_solve(gram, chol32, b[:, 1]).numpy(), x_ref[:, 1], rtol=1e-9, atol=1e-10)


def test_refined_poisson_1d_hits_1e6_parity(refinement):
    """Poisson-1D Dirichlet (singular to machine precision): the float32
    factor plus refinement matches the analytic solution below 1e-6, the
    float64 posterior within 1e-6 (mean) and 1e-5 (std), and the JAX
    refined posterior."""
    bvp = _poisson_data()[0]
    post = _poisson_posterior(lgt, diffops)
    assert post.gram_cholesky.dtype == torch.float32
    grid = np.linspace(-1, 1, 200)
    mean, std = post.mean(grid).numpy(), post.std(grid).numpy()
    jpost = _poisson_posterior(jlgt, jdiffops)
    jmean = np.asarray(jpost.mean(grid))
    config.set(solve_refinement=False)
    post64 = _poisson_posterior(lgt, diffops)
    mean64, std64 = post64.mean(grid).numpy(), post64.std(grid).numpy()

    sol = np.asarray(bvp.solution(grid))
    assert np.max(np.abs(mean - sol)) < 1e-6
    assert np.all(np.isfinite(std)) and np.all(std >= 0)
    assert np.max(np.abs(mean - mean64)) < 1e-6
    assert np.max(np.abs(std - std64)) < 1e-5
    assert np.max(np.abs(mean - jmean)) < 1e-6


def test_refined_operator_pushforward_keeps_solver(refinement):
    """Pushing an operator through a refined posterior keeps the refined
    solver: the factor stays float32 and the posterior of u'' interpolates
    -2, as the JAX one does."""
    grid = np.linspace(-0.9, 0.9, 50)
    ddu = diffops.Derivative(2)(_poisson_posterior(lgt, diffops))
    assert ddu.gram_cholesky.dtype == torch.float32
    mean = ddu.mean(grid).numpy()
    np.testing.assert_allclose(mean, -2.0, atol=1e-5)
    jmean = np.asarray(jdiffops.Derivative(2)(_poisson_posterior(jlgt, jdiffops)).mean(grid))
    np.testing.assert_allclose(mean, jmean, atol=1e-5)


def test_refined_posterior_checkpoint_roundtrip(refinement, tmp_path):
    """A refined posterior (float32 factor, kept float64 Gram, refined
    solver object) round-trips through save_posterior / load_posterior and
    conditions further as the original does."""
    from linpde_gp_tpu_torch.utils.serialization import load_posterior, save_posterior

    post = _poisson_posterior(lgt, diffops)
    path = tmp_path / "refined.pt"
    save_posterior(path, post)
    restored = load_posterior(path, device="cpu")
    assert restored.gram_cholesky.dtype == torch.float32
    grid = np.linspace(-1, 1, 17)
    np.testing.assert_array_equal(restored.mean(grid).numpy(), post.mean(grid).numpy())
    b = lgt.Normal(np.zeros(1), 1e-4 * np.ones(1))
    more = restored.condition_on_observations(np.asarray([0.5]), X=np.asarray([1.5]), b=b)
    ref = post.condition_on_observations(np.asarray([0.5]), X=np.asarray([1.5]), b=b)
    np.testing.assert_allclose(more.mean(grid).numpy(), ref.mean(grid).numpy(), rtol=0, atol=1e-12)
