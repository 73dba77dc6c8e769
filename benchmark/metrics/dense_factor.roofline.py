"""Dense linear algebra (``ops/linalg/chol.py``: ``cholesky``, ``chol_extend``
and the weights' solves, on cuSOLVER and cuBLAS): the floating-point work and
bytes that the four conditioning calls need, computed from N and the anchor
counts, at the FP64 tensor cores' 67 TFLOP/s and 3.35 TB/s, over the
profiler's time of the library's kernels, in per cent."""

from benchmark.harness import yardstick as ys


def read(rec):
    t, launches = rec.trace.dense_library_time()
    if not launches:
        return None
    works = [w for s in rec.steps for w in ys.anchored_conditioning_work(s["n"], s["cuts"])]
    return 100.0 * ys.dense_bound_s(works) / t
