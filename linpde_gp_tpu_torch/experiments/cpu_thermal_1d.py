"""Stationary 1-D CPU-die heat model (``experiments/cpu_thermal_1d.py`` of
the JAX package; the reference's ``experiments/cpu.py`` +
``0000_cpu_stationary_1d.ipynb``).

Geometry/material constants follow the reference's Coffee-Lake die model:
a Poisson equation ``-kappa u'' = q̇_V`` with piecewise-linear per-core
heat sources, a constant heat-sink term, and NEUMANN boundary conditions
expressed through scaled directional derivatives
(``-kappa u'(0) = q̇_A``, reference ``cpu.py:216-228``).  The exact
solution is a piecewise cubic (``Solution_PoissonEquation_IVP_1D_
RHSPiecewisePolynomial``) pinned by a Dirichlet temperature anchor.
"""

import numpy as np

from .common import StageTimer, cli_device, report, setup, to_np


def build_model(lgt):
    width = 16.28
    height = 9.19
    depth = 0.37
    domain = lgt.domains.Interval(0.0, width)

    A_top_bottom = width * height
    A_side_EW = height * depth
    A_sink_1D = A_top_bottom + 2 * A_side_EW

    kappa = 15.6  # W / (mm K)
    TDP = 95.0  # W

    n_cores_x = 3
    core_width = 2.5
    core_offset_x = 1.95
    core_distance_x = 0.35
    core_centers_xs = (
        core_offset_x + (core_width + core_distance_x) * np.arange(n_cores_x, dtype=np.float64) + core_width / 2.0
    )

    # Piecewise-linear per-core heat distribution (reference ``cpu.py:78-107``).
    rel_heights = [0.9, 0.75, 1.0]
    xs = [0.0]
    ys = [0.0]
    eps = core_distance_x / 3
    for cx, h in zip(core_centers_xs, rel_heights):
        xs += [cx - core_width / 2 - eps, cx - core_width / 2, cx + core_width / 2, cx + core_width / 2 + eps]
        ys += [0.0, h, h, 0.0]
    xs += [width]
    ys += [0.0]
    heat_unnorm = lgt.functions.PiecewiseLinear.from_points(xs, ys)
    norm = float(lgt.functionals.LebesgueIntegral(domain)(heat_unnorm))
    core_heat_dist_x = (1.0 / norm) * heat_unnorm

    q_dot_V_src_1D = (TDP / depth / height) * core_heat_dist_x
    q_dot_V_sink_1D = -TDP / A_sink_1D / depth
    q_dot_A_1D = np.full(2, -TDP / A_sink_1D)

    rhs = q_dot_V_src_1D + q_dot_V_sink_1D  # piecewise linear + constant
    pde = lgt.problems.PoissonEquation(domain, rhs=rhs, alpha=kappa)

    solution = lgt.problems.Solution_PoissonEquation_IVP_1D_RHSPiecewisePolynomial(
        domain=domain,
        rhs=rhs,
        initial_values=[60.0, -q_dot_A_1D[0] / kappa],
        alpha=kappa,
    )

    DirectionalDerivative = lgt.diffops.DirectionalDerivative
    boundary_conditions = [
        lgt.problems.pde.BoundaryCondition(
            boundary=domain.boundary[0],
            operator=-kappa * DirectionalDerivative(np.asarray(1.0)),
            values=q_dot_A_1D[0],
        ),
        lgt.problems.pde.BoundaryCondition(
            boundary=domain.boundary[1],
            operator=-kappa * DirectionalDerivative(np.asarray(-1.0)),
            values=q_dot_A_1D[1],
        ),
    ]
    bvp = lgt.problems.pde.BoundaryValueProblem(pde=pde, boundary_conditions=boundary_conditions, solution=solution)
    return bvp, domain, kappa


def main(n_pde=17, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        bvp, domain, kappa = build_model(lgt)

        width = float(domain[1])
        prior = lgt.GaussianProcess(
            mean=lgt.functions.Constant((), 60.0),
            cov=10.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.4 * width),
        )

        with timer("condition_neumann_bc"):
            post = prior
            for bc in bvp.boundary_conditions:
                x_b = np.asarray([float(np.asarray(bc.boundary))])
                post = post.condition_on_observations(bc.values(x_b), X=x_b, L=bc.operator)

        with timer("condition_pde"):
            X_pde = np.asarray(domain.uniform_grid((n_pde,), inset=0.2))
            post = post.condition_on_observations(bvp.pde.rhs(X_pde), X=X_pde, L=bvp.pde.diffop)

        # Temperature anchor (the Neumann problem determines u only up to a
        # constant): one Dirichlet observation at x = 0.
        with timer("condition_anchor"):
            post = post.condition_on_observations(np.asarray([60.0]), X=np.asarray([0.0]))

        grid = np.linspace(0.0, width, 200)
        with timer("posterior_eval"):
            mean = to_np(post.mean(grid))
            std = to_np(post.std(grid))
        sol = to_np(bvp.solution(grid))

        rmse = float(np.sqrt(np.mean((mean - sol) ** 2)))
        max_err = float(np.max(np.abs(mean - sol)))
        coverage = float(np.mean(np.abs(mean - sol) <= 1.96 * std + 1e-9))

        # Aggregate statistic: mean die temperature via the Lebesgue-integral
        # functional applied to the posterior (the notebook's L_stat pattern).
        integral = (1.0 / width) * lgt.functionals.LebesgueIntegral(domain)
        T_avg_rv = integral(post)
        T_avg_true = float(np.trapezoid(sol, grid)) / width

        return report(
            "cpu_thermal_stationary_1d",
            {
                "n_pde": n_pde,
                "rmse": rmse,
                "max_err": max_err,
                "coverage": coverage,
                "T_avg_mean": float(to_np(T_avg_rv.mean)),
                "T_avg_std": float(to_np(T_avg_rv.std)),
                "T_avg_true": T_avg_true,
            },
            timer,
        )


def main_joint(n_pde=17, n_dts=6, device=None):
    """Joint multi-output inference (u, q̇_V, q̇_A) — the notebook's
    ``ufg`` model (``0000_cpu_stationary_1d.ipynb``): unknown heat source
    and boundary flux coupled to the temperature field through the PDE
    and Neumann conditions, plus an aggregate energy-balance statistic."""
    with setup(device) as lgt:
        timer = StageTimer()
        bvp, domain, kappa = build_model(lgt)
        SelectOutput = lgt.diffops.SelectOutput

        width = float(domain[1])
        height = 9.19

        ufg_prior = lgt.GaussianProcess(
            mean=lgt.functions.StackedFunction(
                lgt.functions.Constant((), 57.0),
                lgt.functions.Constant((), float(np.mean(to_np(bvp.pde.rhs(np.linspace(0, width, 64)))))),
                lgt.functions.Constant((), float(to_np(bvp.boundary_conditions[0].values(np.asarray(0.0))))),
            ),
            cov=lgt.kernels.IndependentMultiOutputCovarianceFunction(
                3.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.75 * width),
                0.9**2 * lgt.kernels.Matern((), nu=0.5, lengthscales=width),
                0.9**2 * lgt.kernels.Matern((), nu=0.5, lengthscales=width),
            ),
        )
        select_u = SelectOutput(input_shapes=((), (3,)), idx=0)
        select_qV = SelectOutput(input_shapes=((), (3,)), idx=1)
        select_qA = SelectOutput(input_shapes=((), (3,)), idx=2)

        with timer("condition_pde"):
            X_pde = np.asarray(domain.uniform_grid((n_pde,), inset=0.2))
            post = ufg_prior.condition_on_observations(
                Y=np.zeros_like(X_pde), L=bvp.pde.diffop @ select_u - select_qV, X=X_pde
            )
        with timer("condition_neumann"):
            for bc in bvp.boundary_conditions:
                post = post.condition_on_observations(
                    Y=np.asarray(0.0),
                    L=bc.operator @ select_u - select_qA,
                    X=np.asarray(float(np.asarray(bc.boundary))),
                )
        with timer("condition_dts"):
            X_dts = np.asarray(domain.uniform_grid((n_dts,), inset=0.5))
            post = post.condition_on_observations(
                Y=bvp.solution(X_dts),
                L=select_u,
                X=X_dts,
                b=lgt.Normal(np.zeros(n_dts), 0.1**2 * np.eye(n_dts)),
            )
        with timer("condition_stat"):
            L_stat = height * lgt.functionals.LebesgueIntegral(input_domain=domain) @ select_qV + height * (
                select_qA.to_linfunctl(np.asarray(width)) + select_qA.to_linfunctl(np.asarray(0.0))
            )
            post = post.condition_on_observations(Y=np.asarray(0.0), L=L_stat)

        grid = np.linspace(0.0, width, 120)
        with timer("posterior_eval"):
            u_post = select_u(post)
            mean = to_np(u_post.mean(grid))
            std = to_np(u_post.std(grid))
        sol = to_np(bvp.solution(grid))
        rmse = float(np.sqrt(np.mean((mean - sol) ** 2)))
        coverage = float(np.mean(np.abs(mean - sol) <= 1.96 * std + 1e-9))
        stat_rv = L_stat(post)

        return report(
            "cpu_thermal_stationary_1d_joint",
            {
                "n_pde": n_pde,
                "u_rmse": rmse,
                "u_coverage": coverage,
                "energy_balance_mean": float(to_np(stat_rv.mean)),
                "energy_balance_std": float(to_np(stat_rv.std)),
            },
            timer,
            checks={"u_rmse": ("<=", 0.2), "u_coverage": (">=", 0.85)},
        )


if __name__ == "__main__":
    dev = cli_device(__doc__.splitlines()[0])[0]
    main(device=dev)
    main_joint(device=dev)
