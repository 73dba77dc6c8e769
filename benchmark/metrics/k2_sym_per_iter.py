"""Launches of K2's symmetric route (``csrc/gram.cuh::sym_gram_matvec_kernel``,
each unordered pair of ``(H k H*)(X, X)`` once) per CG iteration of the
window (``solve_info``): 1.0 where every matvec of the CG takes the route.
Nothing where the trace holds no such kernel (a program without it)."""


def read(rec):
    _, launches = rec.trace.kernel_time(r"sym_gram_matvec_kernel")
    its = sum(s["iters"] for s in rec.steps if "iters" in s)
    return launches / its if launches and its else None
