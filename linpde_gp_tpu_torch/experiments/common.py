"""Shared experiment harness: the device, stage timing and reporting.

Counterpart of ``experiments/common.py`` of the JAX package.  The port
computes in float64 on every device, so there is no x64 switch: a run
takes its device from ``device=`` (``None``: the default device, the card
unless the CPU is asked for), set as ``config.device`` for the run so that
host-built tensors (quadrature nodes, stiffness matrices) land there too.

The scale experiments (``scaling``, ``gram_noise_floor``,
``wendland_banded``, ``large_scale``, ``grid_mode``, ``variance``,
``precond_spectroscopy``) also share the heat problem of the JAX package's
``bench.py`` and ``experiments/*_tpu.py``, their settings (the JAX scripts'
environment variables, with the card taking the TPU branch's defaults and
the CPU the CPU branch's), the knobs they drop, and a best-of timer.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from ..config import MODES, config, resolve_device
from ..utils.profiling import StageTimer
from ..utils.profiling import _sync as sync

__all__ = [
    "StageTimer", "report", "setup", "to_np", "cli_args", "cli_device", "metric_mismatches", "payload_mismatches",
    "card_branch", "setting", "default_mode", "reject_dropped_knobs", "best_of", "heat_prior", "heat_kernels",
    "heat_ibvp", "ibvp_anchors", "u_star", "kernel_diagonal", "observed_kernel",
]

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
    # The scale experiments (payload_mismatches).  A CG stops on its first
    # recurrence residual under tol, so two roundings of one CG stop
    # anywhere below it: relres is held at the tol of the tests' settings
    # (the JAX scripts' CPU defaults).
    ("heat1d_accuracy_large_scale", "pcg_relres"): 1e-11,
    ("grid_mode_heat1d", "pcg_relres"): 1e-6,
    ("precond_spectroscopy", "relres"): 1e-5,
    # Two block partitions of one blocked CG (tol 1e-8) round each column's
    # solve differently where the multi-column K2 sums a column in another
    # order at another width: up to ~100 tol of max var.
    ("variance_large_scale", "partition_consistency_rel"): 1e-6,
    # The banded and the dense matvec sum each row's ~600 in-support terms
    # (float64) in different orders: max |difference| / max |result| is
    # round-off, ~1e-15 (JAX 1.2e-15, the port 2.2e-15 at n = 4096).
    ("wendland_banded", "agreement_rel_err"): 1e-13,
    # Plain float32 Grams: each entry errs by the rounding of its float32
    # evaluation (~60 operations a pair), and two evaluation orders (the
    # JAX package's interpreted Pallas body, the port's plain version, K1's
    # FMAs) round differently by as much: at n = 256, max |E| / k0 reads
    # 1.63e-7 (JAX) and 1.70e-7 (the port), ||E||_2 / k0 1.14e-6 and 1.60e-6.
    # The floors are 4 eps32 (max entry) and 5e-6 (||E||_2, per n at n = 256),
    # and the coherent reduction, ||E||_2 plain over ff's (2.6e-7, which
    # agree), inherits 5e-6 / 2.6e-7.
    ("gram_noise_floor", "plain.max_entry"): 5e-7,
    ("gram_noise_floor", "plain.norm2_rel"): 5e-6,
    ("gram_noise_floor", "plain.norm2_per_n"): 2e-8,
    ("gram_noise_floor", "coherent_reduction_x"): 20.0,
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


def cli_args(description: str, argv=None, ints: int | None = 0, mode: bool = False) -> argparse.Namespace:
    """A script's command line: up to ``ints`` positional integers
    (``.ints``; ``None``: any number), ``--device`` and, with ``mode``,
    ``--mode``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("ints", nargs="*", type=int)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    if mode:
        ap.add_argument("--mode", default=None, choices=MODES, help="the arithmetic mode (default: the script's)")
    args = ap.parse_args(argv)
    if ints is not None and len(args.ints) > ints:
        ap.error(f"at most {ints} positional integer(s)")
    return args


def cli_device(description: str, argv=None, ints: int = 0):
    """``(device, ints)`` from a script's command line: up to ``ints``
    positional integers and ``--device``."""
    args = cli_args(description, argv, ints)
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


# -- the scale experiments -------------------------------------------------------

#: Payload keys that are times or derived from times, or name the backend:
#: not compared between two runs.
TIMING_KEYS = frozenset({
    "backend", "gram_s", "chol_s", "solve_s", "total_s", "seconds", "gpairs", "compensated_slowdown_x",
    "dense_matvec_s", "banded_matvec_s", "speedup_x", "condition_s_incl_compile", "condition_s",
    "condition_first_s", "condition_steady_s", "refit_s", "posterior_eval_s", "variance_s",
    "variance_s_per_query_ms", "partition_check_s", "build_s",
})
#: CG iteration counts of two runs may differ by this much: two
#: implementations of one CG on one system round differently.
ITER_SLACK = 2
#: The card against the CPU (f64, the tests' sizes): the card's kernels round
#: with FMAs where the CPU's plain versions do not, cuBLAS and the CPU's BLAS
#: sum in other orders, and over hundreds of iterations of an ill-conditioned
#: CG the two runs drift apart by a share of the count (on the H100: 620
#: against 614 iterations of unpreconditioned CG, 77 against 74 under a
#: rank-256 Nystrom preconditioner, 279 against 276 on the grid).
CARD_ITER_RTOL = 0.05
ITER_KEYS = frozenset({"pcg_iters", "iters"})

#: Environment knobs of the JAX scripts that select a path or a tile the
#: port does not carry; a run that sets one raises rather than run another
#: path than its command line names.
DROPPED_KNOBS = {
    "LS_HOST_CG": "the host-orchestrated CG is a workaround of the TPU rig's compile service; the port's CG runs "
                  "on the device",
    "WB_HOST_CG": "the host-orchestrated CG is a workaround of the TPU rig's compile service; the port's CG runs "
                  "on the device",
    "LS_DEVICE_CG": "the port has one CG, the device-state ff CG (pcg_ff); there is no other to select",
    "GM_DEVICE_CG": "the port has one CG, the device-state ff CG (pcg_ff); there is no other to select",
    "LS_BUILD": "the port has one Nystrom build, the floored on-device build (nystrom_preconditioner_device)",
    "GM_BUILD": "the port has one Nystrom build, the floored on-device build (nystrom_preconditioner_device)",
    "WB_TILE0": "a TPU banded tile (VMEM); the port's banded schedule walks blocks of config.matvec_tile rows, "
                "each with its own column window",
    "WB_TILE1": "a TPU banded tile (VMEM); the port's banded schedule walks blocks of config.matvec_tile rows, "
                "each with its own column window",
    "NF_TILE": "the TPU compensated matvec tile (VMEM); the port's kernels take no tile",
}


def reject_dropped_knobs(*names: str) -> None:
    """Raise ``ValueError`` if any of the environment knobs ``names`` (keys
    of :data:`DROPPED_KNOBS`) is set."""
    for name in names:
        if name in os.environ:
            raise ValueError(f"{name} is set, but the port has no such knob: {DROPPED_KNOBS[name]}")


def card_branch(branch, device=None) -> bool:
    """Whether a run takes the JAX script's TPU-branch defaults (else its
    CPU branch's): ``branch`` ``"card"`` or ``"cpu"``, or ``None`` for the
    device's own, the card's on a CUDA ``device`` (``None``: the default
    device)."""
    if branch is None:
        return resolve_device(device).type == "cuda"
    if branch not in ("card", "cpu"):
        raise ValueError(f"branch must be 'card', 'cpu' or None, got {branch!r}")
    return branch == "card"


def setting(name: str, card, cpu, card_run: bool, cast=int):
    """The JAX script's environment variable ``name`` cast by ``cast``, else
    its TPU branch's default ``card`` on the card and its CPU branch's
    ``cpu`` on the CPU."""
    raw = os.environ.get(name)
    if raw is None:
        return card if card_run else cpu
    return bool(int(raw)) if cast is bool else cast(raw)


def default_mode(mode, card_run: bool, card_mode: str) -> str:
    """``mode`` if given, else ``card_mode`` (the JAX script's chip setting:
    ``ff`` where it is compensated, ``plain`` where it runs float32) on the
    card and ``f64`` (its CPU branch's x64) on the CPU."""
    if mode is None:
        mode = card_mode if card_run else "f64"
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode


def log(tag: str, msg: str) -> None:
    """A progress line ``# tag: msg`` on stderr, as the JAX scripts log."""
    print(f"# {tag}: {msg}", file=sys.stderr, flush=True)


def best_of(fn, reps: int):
    """``(seconds, result)``: the least :class:`StageTimer` time (host clock,
    the card synchronized) of ``reps`` calls of ``fn()`` after one warm-up
    call."""
    out = fn()
    sync()
    times = []
    for _ in range(reps):
        timer = StageTimer()
        with timer("call"):
            out = fn()
        times.append(timer.stages["call"])
    return min(times), out


def heat_prior(lgt):
    """The heat benchmark's prior: ``TensorProduct(Matern 3/2 l=2.5, Matern
    5/2 l=2.0)``, zero mean, on the default device."""
    return lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )


def heat_kernels(lgt):
    """``(k_hh, k_cross)``: ``H k H*`` and ``k H*`` of the heat prior with H
    the heat operator, alpha = 0.1 (``bench.py:43-57::_build_kernels`` of
    the JAX package)."""
    from ..ops.transforms import apply_operator_to_kernel

    k = heat_prior(lgt).cov
    H = lgt.diffops.HeatOperator((2,), alpha=0.1)
    return observed_kernel(H, k), apply_operator_to_kernel(H, k, argnum=1)


def observed_kernel(L, k):
    """``L k L*``: the covariance of ``L u`` for ``u`` with covariance ``k``."""
    from ..ops.transforms import apply_operator_to_kernel

    return apply_operator_to_kernel(L, apply_operator_to_kernel(L, k, argnum=1), argnum=0)


def kernel_diagonal(kernel) -> float:
    """``k(x, x)`` of a stationary kernel of the closed-form family, from its
    spec (the JAX scripts' ``_f0`` sum)."""
    from ..ops.gram import kernel_term_specs
    from ..specs import spec_diagonal

    return spec_diagonal(kernel_term_specs(kernel))


def heat_ibvp(lgt):
    """The heat IBVP of ``experiments/large_scale_tpu.py:76-94``: u_t =
    0.1 u_xx on [0, 5] x [-1, 1], initial values the first sine, zero
    boundary values; its ``solution`` is the analytic u*."""
    spatial_domain = lgt.domains.asdomain([-1.0, 1.0])
    return lgt.problems.HeatEquationDirichletProblem(
        t0=0.0, T=5.0, spatial_domain=spatial_domain, alpha=0.1,
        initial_values=lgt.functions.TruncatedSineSeries(spatial_domain, coefficients=[1.0]),
    )


def ibvp_anchors(n_ic: int, n_bc: int) -> np.ndarray:
    """The anchor points, float64: ``n_ic`` initial points at t = 0, then
    ``n_bc`` boundary points at x = -1 and ``n_bc`` at x = 1."""
    X_ic = np.stack([np.zeros(n_ic), np.linspace(-1.0, 1.0, n_ic)], axis=-1)
    t = np.linspace(0.0, 5.0, n_bc)
    X_bc = np.concatenate([np.stack([t, np.full(n_bc, -1.0)], axis=-1), np.stack([t, np.full(n_bc, 1.0)], axis=-1)])
    return np.concatenate([X_ic, X_bc])


def u_star(ibvp, X) -> np.ndarray:
    """``ibvp.solution`` at ``(n, 2)`` points, evaluated in float64 on the
    CPU."""
    return to_np(ibvp.solution(torch.as_tensor(np.asarray(X, np.float64), device="cpu"))).reshape(-1)


def _flat(payload, prefix=""):
    """``{dotted key: leaf}`` of a payload's nested dicts and lists."""
    if isinstance(payload, dict):
        items = payload.items()
    elif isinstance(payload, list) and payload and isinstance(payload[0], (dict, list)):
        items = ((str(i), v) for i, v in enumerate(payload))
    else:
        return {prefix: payload}
    out = {}
    for key, value in items:
        out.update(_flat(value, f"{prefix}.{key}" if prefix else key))
    return out


def payload_mismatches(name: str, got, want, iter_rtol: float = 0.0) -> list[str]:
    """The entries of the scale experiment ``name``'s payload ``got`` (a
    dict, or a list of per-config dicts) that differ from ``want``'s, every
    nested key of ``want`` compared: times and the backend
    (:data:`TIMING_KEYS`) not at all; CG iterations within
    :data:`ITER_SLACK` or ``iter_rtol`` of ``want``'s count; strings and booleans exactly; numbers within
    :data:`METRIC_RTOL` of ``want``'s, or within the floor of a round-off
    metric, ``ROUNDOFF_ATOL[(name, dotted key)]`` or else ``ROUNDOFF_ATOL[(name,
    last key)]``.  ``[]`` if they all agree."""
    have, ref = _flat(got), _flat(want)
    out = []
    for key, b in ref.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in TIMING_KEYS:
            continue
        if key not in have:
            out.append(f"{name}.{key}: missing")
            continue
        a = have[key]
        if isinstance(b, (str, bool)) or b is None:
            ok = a == b
        elif leaf in ITER_KEYS:
            ok = abs(int(a) - int(b)) <= max(ITER_SLACK, iter_rtol * int(b))
        else:
            a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
            floor = ROUNDOFF_ATOL.get((name, key), ROUNDOFF_ATOL.get((name, leaf), 0.0))
            tol = np.maximum(METRIC_RTOL * np.abs(b64), floor)
            ok = a64.shape == b64.shape and bool(np.all(np.abs(a64 - b64) <= tol))
        if not ok:
            out.append(f"{name}.{key}: {a!r} vs {b!r}")
    return out
