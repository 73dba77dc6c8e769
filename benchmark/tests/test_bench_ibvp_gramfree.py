"""The cell ``ibvp.gramfree`` at a CPU size: the program comes out correct,
its control (the program in mode ``plain``) and each planted fault do not,
and ``schur_per_iter`` reads nothing on a trace without anchor spans.

Faults, as ``test_bench_faults.py`` plants them in the gram-free cells: a CG
returning its state unchanged, half of the matvec's points left out, the
mean raised by 1e-5 of its largest; and one of the anchored route's own: the
Schur correction ``W A11^{-1} W^T v`` left out of the CG's matvec."""

import time

import pytest

from benchmark.harness import catalog, trace
from benchmark.harness.runner import run_cell
from benchmark.conftest import STEPS
from benchmark.tests import test_bench_trace_spans as trace_spans
from benchmark.tests.test_bench_faults import _altered, _half_matvec, _unchanged_cg

CELL = "ibvp.gramfree"
#: The configuration's proportions at a CPU size: 1,024 points, 24 + 2 x 12
#: anchors, rank 128.
SIZES = {"n": 1024, "rank": 128, "queries": 256}
SMALL = {"n_ic": 24, "n_bc": 12}
#: ``u_err`` is the collocation's discretization error, set by N: at N =
#: 1,024 it reads 1e-4 to 7e-4 whatever the solver (the cell's limit holds
#: it at N = 1e5).  The other limits are the cell's.
U_ERR_AT_CPU_SIZE = 2e-3


@pytest.fixture
def small(cpu, monkeypatch):
    """The cell's files with the anchors and ``u_err``'s limit at the CPU size."""
    config, workload = catalog.config, catalog.workload

    def cfg(name, *a):
        out = config(name, *a)
        return dict(out, **SMALL) if name == "ibvp_gramfree_1e5" else out

    def wl(name, *a):
        out = workload(name, *a)
        if name == CELL:
            out = dict(out, check=dict(out["check"], limits=dict(out["check"]["limits"], u_err=U_ERR_AT_CPU_SIZE)))
        return out

    monkeypatch.setattr(catalog, "config", cfg)
    monkeypatch.setattr(catalog, "workload", wl)


def run(control=False, seed=2**33 + 29):
    return run_cell(CELL, seed, 0.5, False, t_process=time.perf_counter(), device="cpu", sizes=SIZES,
                    control=control)


def test_program_correct_control_not(small):
    good = run()
    assert good["correct"] and good["failed"] == 0, good["checks"]
    assert set(good["checks"]) == {"relres", "mean_gap", "u_err"}
    bad = run(control=True)
    assert not bad["correct"], bad["checks"]


def _no_schur(self, v_ff):
    return self._gram_matvec_raw(v_ff)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "no_schur"])
def test_fault_is_not_correct(fault, small, monkeypatch):
    from linpde_gp_tpu_torch.models import iterative

    reg = iterative.IterativeGPRegressor
    {"unchanged": lambda: monkeypatch.setattr(iterative, "pcg_ff", _unchanged_cg),
     "half": lambda: monkeypatch.setattr(iterative, "gram_matvec", _half_matvec),
     "altered": lambda: monkeypatch.setattr(reg, "mean", _altered(reg.mean)),
     "no_schur": lambda: monkeypatch.setattr(reg, "_cg_matvec", _no_schur)}[fault]()
    res = run()
    assert not res["correct"], res["checks"]


def _events(schur: bool):
    ev = [trace_spans.window(10_000.0)]
    for t, its in ((100, 3), (5000, 4)):
        ev.append(trace_spans.X("lgt.pcg", "user_annotation", t, 4000))
        for k in range(its):
            ev.append(trace_spans.X("lgt.pcg.matvec", "user_annotation", t + 10 + 500 * k, 200))
            if schur:
                ev.append(trace_spans.X("lgt.anchor.schur", "user_annotation", t + 150 + 500 * k, 50))
    ev.append(trace_spans.X("lgt.anchor.schur", "user_annotation", 9500, 20))  # a var's, outside lgt.pcg
    return ev


@pytest.mark.parametrize("schur", [True, False])
def test_schur_per_iter(schur):
    rec = trace_spans._record("heat.condition", trace.parse(_events(schur)))
    rec.cell, rec.steps = CELL, [dict(STEPS[CELL][0], iters=3), dict(STEPS[CELL][0], iters=4)]
    got = catalog.reader("schur_per_iter").read(rec)
    assert got == (pytest.approx(1.0) if schur else None)
