"""Blocked-CG iterations per variance block (``IterativeGPRegressor.var_info``),
the mean over the window's blocks."""


def read(rec):
    its = [it for s in rec.steps for it in s.get("block_iters", [])]
    return sum(its) / len(its) if its else None
