"""Reads of the device by the host per CG iteration (``pcg_ff``): the
program's ``lgt.host_read`` spans inside its ``lgt.pcg`` spans, over the
window's iterations (``solve_info``).  Each solve reads ``||b||`` once and
one pair of scalars an iteration: 1 + 1 / iterations."""

from benchmark.harness.spans import count_inside


def read(rec):
    reads, solves = count_inside(rec.trace, "lgt.host_read", "lgt.pcg")
    its = sum(s["iters"] for s in rec.steps if "iters" in s)
    return reads / its if solves and its else None
