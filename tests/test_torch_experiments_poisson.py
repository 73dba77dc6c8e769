"""The port's numerics experiments (``linpde_gp_tpu_torch/experiments``)
against the JAX package's scripts (``experiments/*.py``): the Poisson and
heat runs.  Each run's metrics must match the JAX script's ``main()``
payload at relative 1e-6 (round-off metrics at the floors of
``experiments.common.ROUNDOFF_ATOL``); the thermal runs are in
``test_torch_experiments_thermal.py``, so that each file stays short."""

import importlib
import importlib.util
import os
import sys

import pytest
import torch

from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.experiments.common import metric_mismatches

torch.set_num_threads(1)
config.set(device="cpu")

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments")


def jax_script(name):
    """The JAX package's ``experiments/<name>.py`` (which imports its
    ``common`` from that directory)."""
    if EXPERIMENTS not in sys.path:
        sys.path.insert(0, EXPERIMENTS)
    spec = importlib.util.spec_from_file_location(f"jax_experiments_{name}", os.path.join(EXPERIMENTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_run(name, fn, args):
    want = getattr(jax_script(name), fn)(*args)
    got = getattr(importlib.import_module(f"linpde_gp_tpu_torch.experiments.{name}"), fn)(*args, device="cpu")
    assert set(got) == set(want) == {"experiment", "metrics", "wall_clock_s"}
    assert list(got["wall_clock_s"]) == list(want["wall_clock_s"])
    assert metric_mismatches(got, want) == []


@pytest.mark.parametrize(
    "name,fn,args",
    [
        ("poisson_1d", "main", (3,)),
        ("poisson_1d", "main", (20,)),
        ("poisson_2d", "main", ()),
        ("heat_1d", "main", ()),
        ("poisson_fem", "main", ()),
    ],
    ids=["poisson_1d-n3", "poisson_1d-n20", "poisson_2d", "heat_1d", "poisson_fem"],
)
def test_metrics_match_the_jax_script(name, fn, args):
    check_run(name, fn, args)


def test_metric_mismatches_sees_a_relative_error():
    want = {"experiment": "poisson_dirichlet_2d", "metrics": {"mae": 0.1, "range": [1.0, 2.0]}}
    close = {"experiment": "poisson_dirichlet_2d", "metrics": {"mae": 0.1 * (1 + 5e-7), "range": [1.0, 2.0]}}
    far = {"experiment": "poisson_dirichlet_2d", "metrics": {"mae": 0.1 * (1 + 2e-6), "range": [1.0, 2.0 + 1e-5]}}
    assert metric_mismatches(close, want) == []
    assert len(metric_mismatches(far, want)) == 2
    assert metric_mismatches({"experiment": "poisson_dirichlet_2d", "metrics": {}}, want) == [
        "poisson_dirichlet_2d.mae: missing", "poisson_dirichlet_2d.range: missing"]
