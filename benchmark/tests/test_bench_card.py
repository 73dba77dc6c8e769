"""On the card: a short run of each cell through ``run.py`` prints a correct
result line, a traced one its per-layer metrics with every share of a peak
at most 100 %; heat.variance's control comes out not correct at the cell's
own size.  Run on a machine with a card:

    python -m pytest benchmark/tests/test_bench_card.py -q -o addopts=""
"""

import json
import subprocess
import sys
import time

import pytest

from benchmark.harness import catalog
from benchmark.harness.runner import run_cell

CELLS = [w["name"] for w in catalog.manifest()["workloads"]]


def run(cell, trace):
    out = subprocess.run([sys.executable, str(catalog.BENCH / "run.py"), "--workload", cell, "--seed", "77",
                          "--seconds", "2", "--trace", str(trace)], capture_output=True, text=True,
                         cwd=catalog.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, card):
    res = run(cell, 0)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in catalog.cell_metrics(catalog.manifest(), cell, False)}
    traced = run(cell, 1)
    assert traced["correct"] and 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    for name, m in traced["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)


@pytest.mark.card
def test_variance_control_at_the_cells_size(card):
    good = run_cell("heat.variance", 2**33 + 5, 1.0, False, t_process=time.perf_counter())
    assert good["correct"], good["checks"]
    bad = run_cell("heat.variance", 2**33 + 5, 1.0, False, t_process=time.perf_counter(), control=True)
    assert not bad["correct"], bad["checks"]
