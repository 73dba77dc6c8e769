"""1-D Poisson inverse problem: joint posterior over the solution u and
the unknown right-hand side f (``experiments/poisson_1d_inverse_rhs.py`` of
the JAX package).

Replicates ``experiments/0003_poisson_1d_inverse_rhs.ipynb``:
u* = exp(-(x - mu)^2 / (2 sigma^2)), f* = -u*''; observe boundary values
and noisy point values of u; infer f through the PDE coupling
``-Δu - f = 0`` with the f-prior entering as correlated "noise".
"""

import numpy as np
import torch

from .common import StageTimer, cli_device, report, setup, to_np


def main(n_meas=10, n_pde=10, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        domain = lgt.domains.asdomain((-1.0, 1.0))
        mu, sigma = 0.4, 0.3
        u_true = lgt.functions.LambdaFunction(lambda x: torch.exp(-0.5 / sigma**2 * (x - mu) ** 2), ())
        f_true = lgt.functions.LambdaFunction(
            lambda x: (1.0 - ((x - mu) / sigma) ** 2) / sigma**2 * u_true(x), ()
        )
        bvp = lgt.problems.PoissonEquationDirichletProblem(
            domain,
            rhs=f_true,
            boundary_values=(float(u_true(np.asarray(-1.0))), float(u_true(np.asarray(1.0)))),
            solution=u_true,
        )

        u_prior = lgt.GaussianProcess(lgt.functions.Zero(()), lgt.kernels.ExpQuad((), lengthscales=0.5))
        f_prior = lgt.GaussianProcess(lgt.functions.Zero(()), 10.0**2 * lgt.kernels.ExpQuad((), lengthscales=0.25))

        X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)
        with timer("condition_u"):
            u_bc = u_prior.condition_on_observations(Y_bc, X=X_bc)

            X_meas = np.asarray(domain.uniform_grid((n_meas + 2,)))[1:-1]
            Y_meas = bvp.solution(X_meas)
            err_meas = lgt.Normal(np.zeros_like(X_meas), np.diag(np.full_like(X_meas, 0.1**2)))
            u_bc_meas = u_bc.condition_on_observations(X=X_meas, Y=Y_meas, b=err_meas)

            # PDE coupling: 0 = -Δu(X) - f(X); the f-prior enters as noise.
            u_post = u_bc_meas.condition_on_observations(
                X=X_meas, Y=np.zeros_like(X_meas), L=bvp.pde.diffop, b=-f_prior(X_meas)
            )

        with timer("condition_f"):
            X_pde = np.asarray(domain.uniform_grid((n_pde,)))
            Lu_X_pde = bvp.pde.diffop(u_bc_meas)(X_pde)
            f_post = f_prior.condition_on_observations(X=X_pde, Y=np.zeros_like(X_pde), b=-Lu_X_pde)

        grid = np.linspace(-1, 1, 150)
        with timer("posterior_eval"):
            u_mean = to_np(u_post.mean(grid))
            u_std = to_np(u_post.std(grid))
            f_mean = to_np(f_post.mean(grid))
            f_std = to_np(f_post.std(grid))

        u_star = to_np(bvp.solution(grid))
        f_star = to_np(f_true(grid))
        u_rmse = float(np.sqrt(np.mean((u_mean - u_star) ** 2)))
        f_rmse = float(np.sqrt(np.mean((f_mean - f_star) ** 2)))
        f_cov = float(np.mean(np.abs(f_mean - f_star) <= 1.96 * f_std + 1e-12))
        u_cov = float(np.mean(np.abs(u_mean - u_star) <= 1.96 * u_std + 1e-12))

        return report(
            "poisson_1d_inverse_rhs",
            {"u_rmse": u_rmse, "f_rmse": f_rmse, "u_coverage": u_cov, "f_coverage": f_cov},
            timer,
            checks={
                "u_rmse": ("<=", 0.06),
                "f_rmse": ("<=", 2.5),
                "u_coverage": (">=", 0.9),
                "f_coverage": (">=", 0.9),
            },
        )


if __name__ == "__main__":
    main(device=cli_device(__doc__.splitlines()[0])[0])
