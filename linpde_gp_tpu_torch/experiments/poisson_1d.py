"""1-D Poisson with Dirichlet BCs, ExpQuad prior (``experiments/poisson_1d.py``
of the JAX package).

Replicates the reference's ``experiments/0000_poisson_dirichlet_1d.ipynb``
(domain [-1, 1], f = 2, g = (0, 1), sigma = 2, l = 1): condition on PDE
collocation then boundary values, compare against the exact quadratic
solution.
"""

import numpy as np

from .common import StageTimer, cli_device, report, setup, to_np


def main(n_pde=3, plot=False, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        bvp = lgt.problems.PoissonEquationDirichletProblem(
            domain=lgt.domains.asdomain([-1.0, 1.0]),
            rhs=lgt.functions.Constant((), 2.0),
            boundary_values=(0.0, 1.0),
        )
        u_prior = lgt.GaussianProcess(
            mean=lgt.functions.Zero(()),
            cov=2.0**2 * lgt.kernels.ExpQuad((), lengthscales=1.0),
        )

        X_pde = bvp.domain.uniform_grid((n_pde,), inset=0.2 if n_pde == 3 else 0.0)
        Y_pde = bvp.pde.rhs(X_pde)
        X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)

        with timer("condition_pde"):
            u_pde = u_prior.condition_on_observations(Y_pde, X=X_pde, L=bvp.pde.diffop)
        with timer("condition_bc"):
            u_post = u_pde.condition_on_observations(Y_bc, X=X_bc)

        grid = np.linspace(-1, 1, 200)
        with timer("posterior_eval"):
            mean = to_np(u_post.mean(grid))
            std = to_np(u_post.std(grid))
        sol = to_np(bvp.solution(grid))

        rmse = float(np.sqrt(np.mean((mean - sol) ** 2)))
        max_err = float(np.max(np.abs(mean - sol)))
        coverage = float(np.mean(np.abs(mean - sol) <= 1.96 * std + 1e-12))

        if plot:
            import matplotlib.pyplot as plt

            from ..utils import plotting  # noqa: F401  (attaches .plot)

            fig, ax = plt.subplots()
            u_post.plot(ax, grid, num_samples=5, label="posterior")
            ax.plot(grid, sol, label="solution")
            ax.legend()
            fig.savefig("poisson_1d.png", dpi=120)

        checks = {"rmse": ("<=", 0.08), "coverage": (">=", 0.8)}
        if n_pde >= 20:
            # Dense collocation: the posterior is solver-limited, not prior-limited.
            checks = {"max_err": ("<=", 1e-6)}
        return report(
            "poisson_dirichlet_1d",
            {"n_pde": n_pde, "rmse": rmse, "max_err": max_err, "coverage": coverage},
            timer,
            checks=checks,
        )


if __name__ == "__main__":
    dev, ints = cli_device(__doc__.splitlines()[0], ints=1)
    main(n_pde=ints[0] if ints else 3, device=dev)
