"""The JAX package's experiments (``experiments/*.py``) on the port.

The numerics experiments condition a GP on a linear PDE problem and report
its errors against an analytic or oracle solution, with per-stage seconds;
each script's ``main(..., device=None)`` returns the JAX script's payload
(``experiment``, ``metrics``, ``wall_clock_s``) and prints it as JSON:

    python -m linpde_gp_tpu_torch.experiments.run_all            # on the card
    python -m linpde_gp_tpu_torch.experiments.poisson_1d 20 --device cpu

The scale experiments (``large_scale``, ``grid_mode``, ``variance``,
``wendland_banded``, ``scaling``, ``gram_noise_floor``,
``precond_spectroscopy``) run the JAX package's chip-scale scripts: they
read the JAX script's environment variables, default to its TPU branch's
settings on the card and its CPU branch's on the CPU, and print and return
its JSON payload:

    python -m linpde_gp_tpu_torch.experiments.large_scale        # N = 1e5 on the card
    LS_N=512 python -m linpde_gp_tpu_torch.experiments.large_scale --device cpu
"""
