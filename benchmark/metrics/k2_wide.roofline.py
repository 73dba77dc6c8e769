"""K2's multi-column route (``csrc/gram.cuh::gram_matmat_kernel``): the frozen
bound of the blocked CG's Gram products ``(H k H*)(X, X) P`` (r columns of a
variance block, every iteration) over the profiler's time of that kernel, in
per cent."""

from benchmark.harness import yardstick as ys


def read(rec):
    t, launches = rec.trace.kernel_time(r"gram_matmat_kernel")
    if not launches:
        return None
    prec, f = ys.precision(rec.mode), rec.cfg["forms"]
    works = []
    for s in rec.steps:
        q, bs = s["work"], s["block_size"]
        for b, its in enumerate(s["block_iters"]):
            r = min(bs, q - b * bs)
            works += [ys.matvec_work(f["hk_hs"], prec, s["n"], s["n"], r, symmetric=True)] * its
    return 100.0 * ys.calls_bound_s(works) / t
