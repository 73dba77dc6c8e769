"""K1 (``csrc/gram.cuh::gram_kernel``): the frozen bound of the Gram blocks the
window's conditionings need over the profiler's time of that kernel, in per
cent.  Gram-free: the Nyström block ``(H k H*)(X, Z)`` of each build (``Z``,
the landmarks, are among ``X``).  Dense: each step's joint Gram of the
anchors and the PDE points, each symmetric block's pairs once."""

from benchmark.harness import yardstick as ys


def read(rec):
    t, launches = rec.trace.kernel_time(r"\bgram_kernel")
    if not launches:
        return None
    prec, f = ys.precision(rec.mode), rec.cfg["forms"]
    works = []
    for s in rec.steps:
        if "rank" in s:
            works.append(ys.gram_work(f["hk_hs"], prec, s["n"], s["rank"]))
        else:
            na = sum(s["cuts"])
            works += [ys.gram_work(f["hk_hs"], prec, s["n"], s["n"], symmetric=True),
                      ys.gram_work(f["k_hs"], prec, na, s["n"]),
                      ys.gram_work(f["k"], prec, na, na, symmetric=True)]
    return 100.0 * ys.calls_bound_s(works) / t
