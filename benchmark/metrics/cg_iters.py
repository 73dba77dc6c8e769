"""CG iterations per solve (``IterativeGPRegressor.solve_info``), the mean
over the window's solves: preconditioner quality apart from the cost of an
iteration."""


def read(rec):
    its = [s["iters"] for s in rec.steps if "iters" in s]
    return sum(its) / len(its) if its else None
