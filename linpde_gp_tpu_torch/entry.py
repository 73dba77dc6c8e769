"""The port's counterpart of ``__graft_entry__.entry()``.

:func:`entry` builds the small heat-equation posterior of the JAX
package's entry point (``__graft_entry__.py:57-114``) on the dense engine
and returns ``(forward, (xq,))``: ``forward(xq)`` is the posterior mean
and standard deviation on a 16 x 16 space-time grid.  On the card the
build launches K1 (the Gram blocks) and ``forward`` K2 (the mean).

    python -m linpde_gp_tpu_torch.entry            # on the card
    python -m linpde_gp_tpu_torch.entry --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config, resolve_device

#: The Cholesky jitter of the JAX entry's build (relative to the mean
#: diagonal).
ENTRY_JITTER = 1e-6


def build_heat_posterior(n_pde=(12, 8), n_ic=5, n_bc=12, device=None):
    """``(post, ibvp)``: the heat IBVP on [0, 5] x [-1, 1], alpha = 0.1,
    u(0, x) = sin(pi (x + 1) / 2), conditioned on ``n_ic`` initial values,
    ``n_bc`` values on each boundary and ``H u = 0`` on an ``n_pde`` grid,
    with ``cholesky_jitter`` at :data:`ENTRY_JITTER` during the build (the
    global config is restored after).  ``device``: ``None`` for the default
    device (the card unless the CPU is asked for)."""
    import linpde_gp_tpu_torch as lgt

    device = str(resolve_device(device))
    saved = config.cholesky_jitter, config.device
    config.set(cholesky_jitter=ENTRY_JITTER, device=device)
    try:
        spatial_domain = lgt.domains.asdomain([-1.0, 1.0])
        ibvp = lgt.problems.HeatEquationDirichletProblem(
            t0=0.0,
            T=5.0,
            spatial_domain=spatial_domain,
            alpha=0.1,
            initial_values=lgt.functions.TruncatedSineSeries(spatial_domain, coefficients=[1.0]),
        )
        prior = lgt.GaussianProcess(
            lgt.functions.Zero((2,)),
            1.0 * lgt.kernels.TensorProduct(
                lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
                lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
            ),
            device=device,
        )
        X_ic = np.asarray(ibvp.initial_domain.uniform_grid(n_ic, inset=1e-6))
        Y_ic = ibvp.initial_condition.values(X_ic[..., 1])
        post = prior.condition_on_observations(Y_ic, X=X_ic)
        for bc in ibvp.boundary_conditions:
            X_bc = np.asarray(bc.boundary.uniform_grid(n_bc))
            post = post.condition_on_observations(bc.values(X_bc), X=X_bc)
        X_pde = np.asarray(ibvp.domain.uniform_grid(n_pde)).reshape(-1, 2)
        post = post.condition_on_observations(np.zeros(X_pde.shape[0]), X=X_pde, L=ibvp.pde.diffop)
    finally:
        config.set(cholesky_jitter=saved[0], device=saved[1])
    return post, ibvp


def entry(device=None):
    """Return ``(forward, (xq,))``: ``forward(xq) = (post.mean(xq),
    post.std(xq))`` of :func:`build_heat_posterior`'s posterior, ``xq`` the
    (256, 2) float64 points of a 16 x 16 grid of the domain on ``device``."""
    post, ibvp = build_heat_posterior(device=device)

    def forward(xq):
        return post.mean(xq), post.std(xq)

    xq = torch.as_tensor(np.asarray(ibvp.domain.uniform_grid((16, 16))).reshape(-1, 2), dtype=torch.float64)
    return forward, (xq.to(post.device),)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Run the port's entry() once.")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    fn, (xq,) = entry(args.device)
    mean, std = fn(xq)
    print("entry ok:", tuple(mean.shape), tuple(std.shape), mean.device)
