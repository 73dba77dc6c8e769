"""2-D Poisson with Dirichlet BCs, product-Matérn prior
(``experiments/poisson_2d.py`` of the JAX package).

Replicates ``experiments/0001_poisson_dirichlet_2d.ipynb``: domain
[-1,1]^2, f = 2, zero boundary, 2^2 Matérn(2.5) x Matérn(2.5) prior,
N_pde = 20x20, N_bc = 4x20 (inset 1e-6).  The truth at the grid is the
double sine series of -Δu = 2.
"""

import numpy as np

from .common import StageTimer, cli_device, report, setup, to_np


def fourier_solution(xy, terms=101):
    """Series solution of -Δu = 2 on [-1,1]^2 with zero boundary."""
    xy = np.asarray(xy)
    x = (xy[..., 0] + 1.0) / 2.0
    y = (xy[..., 1] + 1.0) / 2.0
    total = np.zeros(x.shape)
    for m in range(1, terms, 2):
        for n in range(1, terms, 2):
            coef = 16.0 / (np.pi**2 * m * n) * 2.0 / (np.pi**2 / 4.0 * (m * m + n * n) * 4.0)
            total += coef * np.sin(m * np.pi * x) * np.sin(n * np.pi * y) * 4.0
    return total


def main(n_pde=20, n_bc=20, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        bvp = lgt.problems.PoissonEquationDirichletProblem(
            domain=lgt.domains.Box([[-1.0, 1.0], [-1.0, 1.0]]),
            rhs=lgt.functions.Constant((2,), 2.0),
            boundary_values=lgt.functions.Constant((2,), 0.0),
        )
        prior = lgt.GaussianProcess(
            mean=lgt.functions.Zero((2,)),
            cov=2.0**2 * lgt.kernels.TensorProduct(
                lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
                lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
            ),
        )

        with timer("condition_bc"):
            post = prior
            for bc in bvp.boundary_conditions:
                X_bc = np.asarray(bc.boundary.uniform_grid(n_bc, inset=1e-6)).reshape(-1, 2)
                post = post.condition_on_observations(bc.values(X_bc), X=X_bc)

        with timer("condition_pde"):
            X_pde = np.asarray(bvp.domain.uniform_grid((n_pde, n_pde))).reshape(-1, 2)
            post = post.condition_on_observations(bvp.pde.rhs(X_pde), X=X_pde, L=bvp.pde.diffop)

        with timer("posterior_eval"):
            grid = np.asarray(bvp.domain.uniform_grid((50, 50))).reshape(-1, 2)
            mean = to_np(post.mean(grid))
            std = to_np(post.std(grid))

        sol = fourier_solution(grid)
        mae = float(np.mean(np.abs(mean - sol)))
        rmse = float(np.sqrt(np.mean((mean - sol) ** 2)))
        center_err = abs(float(post.mean(np.zeros(2))) - 0.5893706973679599)

        return report(
            "poisson_dirichlet_2d",
            {
                "n_obs": n_pde**2 + 4 * n_bc,
                "mae": mae,
                "rmse": rmse,
                "center_abs_err": center_err,
                "max_std": float(std.max()),
            },
            timer,
            checks={"rmse": ("<=", 0.16), "center_abs_err": ("<=", 0.25)},
        )


if __name__ == "__main__":
    main(device=cli_device(__doc__.splitlines()[0])[0])
