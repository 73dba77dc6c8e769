"""The JAX package's numerics experiments (``experiments/*.py``) on the
port: each script conditions a GP on a linear PDE problem and reports its
errors against an analytic or oracle solution, with per-stage seconds.

    python -m linpde_gp_tpu_torch.experiments.run_all            # on the card
    python -m linpde_gp_tpu_torch.experiments.poisson_1d 20 --device cpu

Each script's ``main(..., device=None)`` returns the JAX script's payload
(``experiment``, ``metrics``, ``wall_clock_s``) and prints it as JSON.
"""
