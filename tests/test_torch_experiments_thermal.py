"""The port's numerics experiments against the JAX package's scripts: the
inverse-problem and CPU-die thermal runs, and the port's runner (see
``test_torch_experiments_poisson.py``)."""

import json

import pytest
import torch

from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.experiments import run_all

from test_torch_experiments_poisson import check_run

torch.set_num_threads(1)
config.set(device="cpu")


@pytest.mark.parametrize(
    "name,fn",
    [
        ("poisson_1d_inverse_rhs", "main"),
        ("cpu_thermal_1d", "main"),
        ("cpu_thermal_1d", "main_joint"),
        ("cpu_thermal_2d", "main"),
    ],
    ids=["poisson_1d_inverse_rhs", "cpu_thermal_1d", "cpu_thermal_1d_joint", "cpu_thermal_2d"],
)
def test_metrics_match_the_jax_script(name, fn):
    check_run(name, fn, ())


def test_run_all_prints_one_payload_per_run(capsys):
    """The runner prints the nine runs of the JAX runner, in its order, as
    one JSON line each, and writes no file."""
    run_all.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    runs = [json.loads(line) for line in lines]
    assert [r["run"] for r in runs] == [name for name, _ in run_all.RUNS]
    assert len(runs) == 9 and all({"experiment", "metrics", "wall_clock_s"} <= set(r) for r in runs)
