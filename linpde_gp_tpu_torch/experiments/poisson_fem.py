"""Poisson with FEM-projected (Galerkin) observations: GP vs FEM
(``experiments/poisson_fem.py`` of the JAX package).

Replicates ``experiments/0002_poisson_dirichlet_fem.ipynb`` /
``_gp_fem.ipynb``: condition a Matérn prior on boundary values and on the
weak-form stiffness observations ``A P[u] = b`` assembled from a P1 hat
basis; compare the full-GP posterior and its FEM projection to the exact
solution, and to the classical FEM solution (solve ``A w = b`` directly).
"""

import numpy as np

from .common import StageTimer, cli_device, report, setup, to_np


def main(num_elements=5, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        bvp = lgt.problems.PoissonEquationDirichletProblem(
            domain=lgt.domains.asdomain([-1.0, 1.0]),
            rhs=lgt.functions.Constant((), 2.0),
            boundary_values=(0.0, 1.0),
        )

        basis_grid = np.linspace(-1.0, 1.0, num_elements + 2)
        trial_basis = lgt.functions.UnivariateLinearInterpolationBasis(basis_grid, zero_boundary=False)
        test_basis = lgt.functions.UnivariateLinearInterpolationBasis(basis_grid, zero_boundary=True)
        trial_proj = trial_basis.l2_projection()
        test_proj = test_basis.l2_projection(normalized=False)

        with timer("galerkin_assembly"):
            diffop_galerkin = bvp.pde.diffop.weak_form(test_basis)(trial_basis)
            rhs_galerkin = test_proj(bvp.pde.rhs)

        u_prior = lgt.GaussianProcess(
            mean=lgt.functions.Zero(()),
            cov=1.0 * lgt.kernels.Matern((), nu=1.5, lengthscales=1.0),
        )
        X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)

        with timer("condition"):
            post = u_prior.condition_on_observations(Y_bc, X=X_bc)
            post = post.condition_on_observations(rhs_galerkin, L=diffop_galerkin @ trial_proj)

        grid = np.linspace(-1, 1, 200)
        with timer("posterior_eval"):
            mean = to_np(post.mean(grid))
            std = to_np(post.std(grid))
        sol = to_np(bvp.solution(grid))

        # Classical FEM comparison: solve the interior stiffness system.
        with timer("classical_fem"):
            A = to_np(diffop_galerkin.todense())
            b = to_np(rhs_galerkin)
            Y_bc = to_np(Y_bc)
            bc_contrib = A[:, 0] * Y_bc[0] + A[:, -1] * Y_bc[1]
            w_int = np.linalg.solve(A[:, 1:-1], b - bc_contrib)
            w = np.concatenate([[Y_bc[0]], w_int, [Y_bc[1]]])
            fem_sol = to_np(trial_basis(grid)) @ w

        gp_rmse = float(np.sqrt(np.mean((mean - sol) ** 2)))
        fem_rmse = float(np.sqrt(np.mean((fem_sol - sol) ** 2)))
        # The GP posterior mean conditioned on exactly the Galerkin data
        # reproduces the FEM solution at the nodes.
        node_diff = float(np.max(np.abs(to_np(trial_proj(post).mean) - w)))

        return report(
            "poisson_dirichlet_fem",
            {
                "num_elements": num_elements,
                "gp_rmse": gp_rmse,
                "fem_rmse": fem_rmse,
                "gp_fem_node_diff": node_diff,
                "max_std": float(std.max()),
            },
            timer,
            checks={"gp_rmse": ("<=", 0.09), "fem_rmse": ("<=", 0.04), "gp_fem_node_diff": ("<=", 0.06)},
        )


if __name__ == "__main__":
    main(device=cli_device(__doc__.splitlines()[0])[0])
