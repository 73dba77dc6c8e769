"""The heat problem (``"problem": "heat"``): the prior ``TensorProduct(Matérn
3/2, Matérn 5/2)`` and ``HeatOperator((2,), alpha)`` through the port's public
names, the reference's kernels from the same numbers, the observations'
noise, and the anchored IBVP's anchors with values from its analytic
solution u*.

The anchors are frozen copies of ``chip_smoke.py``'s ``ibvp_anchors`` and
``u_star`` (``experiments/large_scale_tpu.py``'s IC and BC anchors).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.heat import HeatKernels


def reference_kernels(cfg: dict) -> HeatKernels:
    p = cfg["prior"]
    return HeatKernels(p["lengthscale_t"], p["lengthscale_x"], cfg["operator"]["alpha"])


def noise_variance(cfg: dict) -> float:
    """The PDE observations' noise: ``noise_rel`` times ``(H k H*)(x, x)``."""
    return cfg["noise_rel"] * reference_kernels(cfg).diag_hk_hs()


def program(lgt, cfg: dict, device):
    """``(prior, H)``: ``GaussianProcess(Zero, TensorProduct(Matérn 3/2,
    Matérn 5/2))`` on ``device`` and ``HeatOperator((2,), alpha)``."""
    p = cfg["prior"]
    if (p["nu_t"], p["nu_x"], p["scale"]) != (1.5, 2.5, 1.0):
        raise ValueError("the reference covers nu_t = 1.5, nu_x = 2.5, scale = 1 only")
    cov = lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=p["nu_t"], lengthscales=p["lengthscale_t"]),
        lgt.kernels.Matern((), nu=p["nu_x"], lengthscales=p["lengthscale_x"]),
    )
    prior = lgt.GaussianProcess(lgt.functions.Zero((2,)), p["scale"] * cov, device=device)
    return prior, lgt.diffops.HeatOperator((2,), alpha=cfg["operator"]["alpha"])


def u_star(x: torch.Tensor) -> torch.Tensor:
    """The heat IBVP's analytic solution ``sin(pi (x + 1) / 2) exp(-0.1
    (pi / 2)^2 t)`` at points ``(t, x)``."""
    return torch.sin(math.pi * (x[:, 1] + 1.0) / 2.0) * torch.exp(-0.1 * (math.pi / 2.0) ** 2 * x[:, 0])


def anchors(cfg: dict, device, dtype=torch.float64) -> list:
    """``[(x, y), ...]`` in the order they are conditioned on: ``n_ic``
    initial-condition anchors at t = 0, then ``n_bc`` boundary anchors at x =
    -1 and ``n_bc`` at x = 1, with values from u*."""
    (t0, t1), (x0, x1) = cfg["domain"]
    n_ic, n_bc = cfg["n_ic"], cfg["n_bc"]
    t = torch.linspace(t0, t1, n_bc, dtype=dtype)
    sets = [torch.stack([torch.full((n_ic,), t0, dtype=dtype), torch.linspace(x0, x1, n_ic, dtype=dtype)], -1),
            torch.stack([t, torch.full((n_bc,), x0, dtype=dtype)], -1),
            torch.stack([t, torch.full((n_bc,), x1, dtype=dtype)], -1)]
    return [(x, u_star(x)) for x in (x.to(device) for x in sets)]
