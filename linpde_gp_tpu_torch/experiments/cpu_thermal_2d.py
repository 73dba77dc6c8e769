"""Stationary 2-D CPU-die heat model (``experiments/cpu_thermal_2d.py`` of
the JAX package; the reference's ``experiments/0001_cpu_stationary_2d.ipynb``
+ ``cpu.py`` 2-D branch).

``-kappa Δu = q̇_V`` on the 16.28 x 9.19 mm die with separable
per-core heat sources, constant sink, and Neumann flux conditions on all
four edges expressed as scaled directional-derivative collocation.  No
closed-form solution exists in 2-D; fidelity is measured by the PDE
residual at held-out interior points and by global energy balance.
"""

import numpy as np

from .common import StageTimer, cli_device, report, setup, to_np


def main(n_pde=(12, 8), n_bc=8, device=None):
    with setup(device) as lgt:
        timer = StageTimer()
        DirectionalDerivative = lgt.diffops.DirectionalDerivative

        width, height, depth = 16.28, 9.19, 0.37
        domain = lgt.domains.Box([[0.0, width], [0.0, height]])
        kappa = 15.6
        TDP = 95.0
        A_sink = width * height + 2 * width * depth + 2 * height * depth

        # Separable source: x-profile (3 cores) x y-profile (2 rows).
        core_width, core_offset_x, core_distance_x = 2.5, 1.95, 0.35
        core_centers_xs = core_offset_x + (core_width + core_distance_x) * np.arange(3) + core_width / 2
        xs, ys = [0.0], [0.0]
        eps = core_distance_x / 3
        for cx, h in zip(core_centers_xs, [0.9, 0.75, 1.0]):
            xs += [cx - core_width / 2 - eps, cx - core_width / 2, cx + core_width / 2, cx + core_width / 2 + eps]
            ys += [0.0, h, h, 0.0]
        xs += [width]
        ys += [0.0]
        hx = lgt.functions.PiecewiseLinear.from_points(xs, ys)
        hx = (1.0 / float(lgt.functionals.LebesgueIntegral(domain[0])(hx))) * hx

        core_height = 0.45 * height
        cys = np.array([core_height / 2.0, height - core_height / 2.0])
        eps_y = (cys[1] - cys[0] - core_height) / 3
        hy = lgt.functions.PiecewiseLinear.from_points(
            [0.0, cys[0] + core_height / 2, cys[0] + core_height / 2 + eps_y,
             cys[1] - core_height / 2 - eps_y, cys[1] - core_height / 2, height],
            [1.0, 1.0, 0.0, 0.0, 1.0, 1.0],
        )
        hy = (1.0 / float(lgt.functionals.LebesgueIntegral(domain[1])(hy))) * hy

        q_src = lgt.functions.LambdaFunction(lambda xy: TDP / depth * hx(xy[..., 0]) * hy(xy[..., 1]), (2,))
        q_sink = lgt.functions.Constant((2,), -TDP / A_sink / depth)
        rhs = q_src + q_sink
        pde = lgt.problems.PoissonEquation(domain, rhs=rhs, alpha=kappa)

        q_dot_A = -TDP / A_sink
        prior = lgt.GaussianProcess(
            mean=lgt.functions.Constant((2,), 60.0),
            cov=10.0**2 * lgt.kernels.TensorProduct(
                lgt.kernels.Matern((), nu=2.5, lengthscales=0.5 * width),
                lgt.kernels.Matern((), nu=2.5, lengthscales=0.5 * height),
            ),
        )

        # Neumann flux conditions on the four edges: -kappa <n, grad u> = q_A.
        normals = {
            0: np.array([-1.0, 0.0]),  # x = 0 edge
            1: np.array([1.0, 0.0]),  # x = width
            2: np.array([0.0, -1.0]),  # y = 0
            3: np.array([0.0, 1.0]),  # y = height
        }
        with timer("condition_neumann"):
            post = prior
            for i, part in enumerate(domain.boundary):
                X_b = np.asarray(part.uniform_grid(n_bc, inset=1e-6)).reshape(-1, 2)
                op = -kappa * DirectionalDerivative(normals[i])
                post = post.condition_on_observations(np.full(X_b.shape[0], q_dot_A), X=X_b, L=op)

        with timer("condition_pde"):
            X_pde = np.asarray(domain.uniform_grid(n_pde)).reshape(-1, 2)
            Y_pde = to_np(pde.rhs(X_pde))
            post = post.condition_on_observations(Y_pde, X=X_pde, L=pde.diffop)

        with timer("condition_anchor"):
            post = post.condition_on_observations(np.asarray([60.0]), X=np.asarray([[width / 2, height / 2]]))

        with timer("residual_eval"):
            Dpost = pde.diffop(post)
            held_out = np.asarray(domain.uniform_grid((9, 7), inset=0.8)).reshape(-1, 2)
            resid = to_np(Dpost.mean(held_out)) - to_np(pde.rhs(held_out))
            resid_at_colloc = to_np(Dpost.mean(X_pde)) - Y_pde

        grid = np.asarray(domain.uniform_grid((30, 20))).reshape(-1, 2)
        mean = to_np(post.mean(grid))
        std = to_np(post.std(grid))

        return report(
            "cpu_thermal_stationary_2d",
            {
                "n_obs": int(np.prod(n_pde)) + 4 * n_bc + 1,
                "pde_resid_colloc_max": float(np.max(np.abs(resid_at_colloc))),
                "pde_resid_heldout_rms": float(np.sqrt(np.mean(resid**2))),
                "rhs_scale": float(np.max(np.abs(Y_pde))),
                "temp_range": [float(mean.min()), float(mean.max())],
                "max_std": float(std.max()),
            },
            timer,
            checks={"pde_resid_heldout_rms": ("<=", 3.0)},
        )


if __name__ == "__main__":
    main(device=cli_device(__doc__.splitlines()[0])[0])
