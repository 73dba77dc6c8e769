"""K2's narrow route (``csrc/gram.cuh::gram_matvec_kernel`` and its split
sum): the frozen bound of the window's Gram matvecs at r = 1 (each CG
iteration's ``(H k H*)(X, X) p``, each step's mean ``(k H*)(xq, X) w``) over
the profiler's time of those kernels, in per cent."""

from benchmark.harness import yardstick as ys


def read(rec):
    t, launches = rec.trace.kernel_time(r"gram_matvec_kernel|matvec_reduce_kernel")
    if not launches:
        return None
    prec, f = ys.precision(rec.mode), rec.cfg["forms"]
    works = []
    for s in rec.steps:
        works += [ys.matvec_work(f["hk_hs"], prec, s["n"], s["n"], 1, symmetric=True)] * s["iters"]
        works.append(ys.matvec_work(f["k_hs"], prec, s["queries"], s["n"], 1))
    return 100.0 * ys.calls_bound_s(works) / t
