"""Shared experiment harness: the device, stage timing and reporting.

Counterpart of ``experiments/common.py`` of the JAX package.  The port
computes in float64 on every device, so there is no x64 switch: a run
takes its device from ``device=`` (``None``: the default device, the card
unless the CPU is asked for), set as ``config.device`` for the run so that
host-built tensors (quadrature nodes, stiffness matrices) land there too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from ..config import config, resolve_device
from ..utils.profiling import StageTimer

__all__ = ["StageTimer", "report", "setup", "to_np", "cli_device", "metric_mismatches"]

#: Relative tolerance of two runs' metrics (the port against the JAX
#: package, the card against the CPU).
METRIC_RTOL = 1e-6

#: Absolute floors of the metrics that are round-off, ``(experiment, metric)
#: -> atol``.  heat_1d: the 5 initial points sit 1e-6 from the boundary
#: points, so the Schur pivots of the boundary blocks are differences of
#: O(1) numbers ~1e-12 apart and the posterior mean is round-off at ~1e-4
#: (against a 40-digit solve of the initial and boundary stages, the JAX
#: package errs by 1.3e-4 and the port by 7.9e-6; only reordering the
#: boundary points moves the JAX mae by 0.37 % and its coverage by 6e-4);
#: mae and rmse differ by up to 1.3e-5 and the coverage by 4 of 5,000
#: points.  The joint 1-D model is conditioned exactly on its energy
#: balance: its mean and variance there are zeros to round-off (the mean
#: ~1e-13; the variance within 1e-13 of the prior's 1.35e4, so the std
#: within 3.7e-5: the H100 reads 5.0e-6, the CPU 0).  The
#: 2-D residual at the collocation points is a zero to round-off (~1e-14).
ROUNDOFF_ATOL = {
    ("heat_1d", "mae"): 5e-5,
    ("heat_1d", "rmse"): 5e-5,
    ("heat_1d", "coverage"): 2e-3,
    ("cpu_thermal_stationary_1d_joint", "energy_balance_mean"): 1e-11,
    ("cpu_thermal_stationary_1d_joint", "energy_balance_std"): 4e-5,
    ("cpu_thermal_stationary_2d", "pde_resid_colloc_max"): 1e-11,
}
#: poisson_1d's floors from n_pde = 20 on, where the JAX script itself
#: checks only max_err <= 1e-6: its errors (~2e-9, ~4e-9) are the round-off
#: of a solve of condition ~1e12 (two LAPACKs differ by ~2e-10), and so is
#: the posterior std, which makes the coverage a fraction of round-off
#: against round-off (0.85 on the CPU, 0.805 on the H100): not compared.
DENSE_POISSON_ATOL = {"rmse": 1e-9, "max_err": 1e-9, "coverage": 1.0}


def _floor(want: dict, key: str) -> float:
    name, metrics = want["experiment"], want["metrics"]
    if name == "poisson_dirichlet_1d" and metrics.get("n_pde", 0) >= 20:
        return DENSE_POISSON_ATOL.get(key, 0.0)
    return ROUNDOFF_ATOL.get((name, key), 0.0)


@contextlib.contextmanager
def setup(device=None):
    """Yield the port's package with ``config.device`` set to ``device``
    resolved (restored on exit)."""
    import linpde_gp_tpu_torch as lgt

    saved = config.device
    config.device = str(resolve_device(device))
    try:
        yield lgt
    finally:
        config.device = saved


def to_np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def report(name, metrics, timer: StageTimer | None = None, checks=None):
    """Print the JSON payload and enforce the metric tolerances.

    ``checks``: ``metric -> ("<=" | ">=", bound)``; a breach raises
    ``AssertionError`` (skipped with ``LGT_SKIP_CHECKS=1``), as the JAX
    harness does."""
    payload = {"experiment": name, "metrics": metrics}
    if timer is not None:
        payload["wall_clock_s"] = {k: round(v, 4) for k, v in timer.stages.items()}
    print(json.dumps(payload))
    if checks and os.environ.get("LGT_SKIP_CHECKS") != "1":
        for key, (op, bound) in checks.items():
            val = metrics[key]
            ok = val <= bound if op == "<=" else val >= bound
            if not ok:
                raise AssertionError(f"{name}: metric {key}={val!r} violates {op} {bound!r}")
    return payload


def cli_device(description: str, argv=None, ints: int = 0):
    """``(device, ints)`` from a script's command line: up to ``ints``
    positional integers and ``--device``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("ints", nargs="*", type=int)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if len(args.ints) > ints:
        ap.error(f"at most {ints} positional integer(s)")
    return args.device, args.ints


def metric_mismatches(got: dict, want: dict) -> list[str]:
    """The metrics of payload ``got`` that differ from payload ``want``'s by
    more than :data:`METRIC_RTOL` of the latter (or the metric's floor in
    :data:`ROUNDOFF_ATOL` / :data:`DENSE_POISSON_ATOL`), or are missing:
    ``[]`` if they all agree.  ``wall_clock_s`` is not compared."""
    name = want["experiment"]
    out = [] if got["experiment"] == name else [f"experiment {got['experiment']!r} != {name!r}"]
    for key, ref in want["metrics"].items():
        if key not in got["metrics"]:
            out.append(f"{name}.{key}: missing")
            continue
        a, b = np.asarray(got["metrics"][key], np.float64), np.asarray(ref, np.float64)
        tol = np.maximum(METRIC_RTOL * np.abs(b), _floor(want, key))
        if a.shape != b.shape or not np.all(np.abs(a - b) <= tol):
            out.append(f"{name}.{key}: {got['metrics'][key]!r} vs {ref!r}")
    return out
