"""The comparison that decides ``correct``, at a size a test run holds: the
program comes out correct and the control (the next lower precision in the
program's place: the program in mode ``plain`` for the gram-free cells, the
reference in float32 for the dense ones) does not.  The cell's own size is
read on the card by ``benchmark/calibrate.py``.

heat.variance's control is held at the cell's own size on the card
(``test_bench_card.py``): at the configuration's CG tol 1e-5 a float32 and a
float64 variance are both set by the CG's truncation at any size a CPU run
holds (n = 800 and 3,000: both ~2e-6 of the largest variance), and only at N
= 1e5 does float32's CG fail (0.49 against 2.9e-6 on the card)."""

import time

import pytest

from benchmark.harness.runner import run_cell

SIZES = {"heat.condition": {"n": 800, "rank": 128, "queries": 256},
         "heat.variance": {"n": 800, "rank": 128, "queries": 64},
         "ibvp.condition": {"n": 600, "queries": 256},
         "ibvp.query": {"n": 600}}


def run(cell, control=False, seed=2**31 + 17):
    return run_cell(cell, seed, 0.5, False, t_process=time.perf_counter(), device="cpu", sizes=SIZES[cell],
                    control=control)


@pytest.mark.parametrize("cell", [c for c in SIZES if c != "heat.variance"])
def test_program_correct_control_not(cell, cpu):
    good = run(cell)
    assert good["correct"] and good["failed"] == 0, good["checks"]
    assert list(good)[-1] == "checks"
    bad = run(cell, control=True)
    assert not bad["correct"], bad["checks"]
