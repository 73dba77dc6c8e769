"""Run every numerics experiment of the port and print one JSON payload
per run (``experiments/run_all.py`` of the JAX package, which also writes
``RESULTS.md``; this runner writes nothing).

    python -m linpde_gp_tpu_torch.experiments.run_all [--device cpu]
"""

from __future__ import annotations

import contextlib
import io
import json
import time

from . import cpu_thermal_1d, cpu_thermal_2d, heat_1d, poisson_1d, poisson_1d_inverse_rhs, poisson_2d, poisson_fem
from .common import cli_device

#: ``(name, main)`` of every run, in the JAX runner's order; each ``main``
#: takes ``device=``.
RUNS = [
    ("poisson_1d (n=3, paper config)", lambda device=None: poisson_1d.main(3, device=device)),
    ("poisson_1d (n=20)", lambda device=None: poisson_1d.main(20, device=device)),
    ("poisson_2d", poisson_2d.main),
    ("heat_1d", heat_1d.main),
    ("poisson_fem", poisson_fem.main),
    ("poisson_1d_inverse_rhs", poisson_1d_inverse_rhs.main),
    ("cpu_thermal_1d", cpu_thermal_1d.main),
    ("cpu_thermal_1d_joint", cpu_thermal_1d.main_joint),
    ("cpu_thermal_2d", cpu_thermal_2d.main),
]


def run_all(device=None) -> list[tuple[str, dict, float]]:
    """``(name, payload, seconds)`` of every run in :data:`RUNS` on
    ``device``, the scripts' own output swallowed."""
    out = []
    for name, fn in RUNS:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            payload = fn(device=device)
        out.append((name, payload, time.perf_counter() - t0))
    return out


def main(argv=None) -> None:
    device = cli_device(__doc__.splitlines()[0], argv)[0]
    for name, payload, _ in run_all(device):
        print(json.dumps({"run": name, **payload}), flush=True)


if __name__ == "__main__":
    main()
