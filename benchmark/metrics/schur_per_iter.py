"""Schur corrections per CG iteration on the anchored gram-free route: the
program's ``lgt.anchor.schur`` spans (``models/iterative.py::_cg_matvec``)
inside its ``lgt.pcg`` spans, over the window's iterations (``solve_info``).
Every matvec of the Schur CG subtracts ``W A11^{-1} W^T v`` once: 1.0.
Nothing where the trace holds no such span (a program without it)."""

from benchmark.harness.spans import count_inside


def read(rec):
    schur, solves = count_inside(rec.trace, "lgt.anchor.schur", "lgt.pcg")
    its = sum(s["iters"] for s in rec.steps if "iters" in s)
    return schur / its if schur and its else None
