"""1-D heat equation with a space-time TensorProduct Matérn prior
(``experiments/heat_1d.py`` of the JAX package).

Replicates ``experiments/0002_heat_1d.ipynb``: domain [0, 5] x [-1, 1],
alpha = 0.1, sine-series initial condition, Matérn(1.5) x Matérn(2.5)
prior; condition on IC, BCs, then PDE collocation; compare to the
analytic separation-of-variables solution.
"""

import numpy as np

from .common import StageTimer, cli_device, report, setup, to_np


def main(n_pde=(100, 20), n_ic=5, n_bc=50, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        spatial_domain = lgt.domains.asdomain([-1.0, 1.0])
        ibvp = lgt.problems.HeatEquationDirichletProblem(
            t0=0.0,
            T=5.0,
            spatial_domain=spatial_domain,
            alpha=0.1,
            initial_values=lgt.functions.TruncatedSineSeries(spatial_domain, coefficients=[1.0]),
        )
        u_prior = lgt.GaussianProcess(
            mean=lgt.functions.Zero((2,)),
            cov=1.0 * lgt.kernels.TensorProduct(
                lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
                lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
            ),
        )

        with timer("condition_ic"):
            X_ic = np.asarray(ibvp.initial_domain.uniform_grid(n_ic, inset=1e-6))
            post = u_prior.condition_on_observations(ibvp.initial_condition.values(X_ic[..., 1]), X=X_ic)

        with timer("condition_bc"):
            for bc in ibvp.boundary_conditions:
                X_bc = np.asarray(bc.boundary.uniform_grid(n_bc))
                post = post.condition_on_observations(bc.values(X_bc), X=X_bc)

        with timer("condition_pde"):
            X_pde = np.asarray(ibvp.domain.uniform_grid(n_pde)).reshape(-1, 2)
            post = post.condition_on_observations(ibvp.pde.rhs(X_pde), X=X_pde, L=ibvp.pde.diffop)

        with timer("posterior_eval"):
            plt_grid = np.asarray(ibvp.domain.uniform_grid((100, 50))).reshape(-1, 2)
            mean = to_np(post.mean(plt_grid))
            std = to_np(post.std(plt_grid))
        sol = to_np(ibvp.solution(plt_grid))

        mae = float(np.mean(np.abs(mean - sol)))
        rmse = float(np.sqrt(np.mean((mean - sol) ** 2)))
        coverage = float(np.mean(np.abs(mean - sol) <= 1.96 * std + 1e-12))

        return report(
            "heat_1d",
            {"n_obs": int(np.prod(n_pde)) + n_ic + 2 * n_bc, "mae": mae, "rmse": rmse, "coverage": coverage},
            timer,
            checks={"mae": ("<=", 2e-3), "coverage": (">=", 0.95)},
        )


if __name__ == "__main__":
    main(device=cli_device(__doc__.splitlines()[0])[0])
