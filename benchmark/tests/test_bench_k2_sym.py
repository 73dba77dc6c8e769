"""``k2_sym_per_iter`` on synthetic Chrome-trace events: the launches of K2's
symmetric route over the window's CG iterations, and nothing where the
program launched no such kernel (a program without the route); the
narrow route's roofline counts the route's two kernels."""

import pytest

from benchmark.harness import catalog, trace
from benchmark.tests.test_bench_trace_spans import STEPS, X, _record, window

SYM = "void lgt::sym_gram_matvec_kernel<lgt::Structure, lgt::PlainArith<double>, 1>(lgt::SpecValues)"
REDUCE = "void lgt::sym_matvec_reduce_kernel<lgt::PlainArith<double>>(double const*)"
CROSS = "void lgt::gram_matvec_kernel<lgt::Structure, lgt::PlainArith<double>, 1>(lgt::SpecValues)"


def _events(sym_launches):
    ev = [window(10_000.0)]
    for k in range(sym_launches):
        ev += [X(SYM, "kernel", 100 + 300 * k, 200), X(REDUCE, "kernel", 310 + 300 * k, 5)]
    ev.append(X(CROSS, "kernel", 9000, 100))  # the mean's cross form
    return ev


def _rec(sym_launches, iters):
    rec = _record("heat.condition", trace.parse(_events(sym_launches)))
    rec.steps = [dict(STEPS["heat.condition"][0], iters=i) for i in iters]
    return rec


@pytest.mark.parametrize("launches,iters,want", [(7, (3, 4), 1.0), (14, (3, 4), 2.0), (0, (3, 4), None)])
def test_k2_sym_per_iter(launches, iters, want):
    got = catalog.reader("k2_sym_per_iter").read(_rec(launches, iters))
    assert got == (None if want is None else pytest.approx(want))


def test_the_routes_kernels_count_as_k2s_narrow_route():
    tr = trace.parse(_events(3))
    t, n = tr.kernel_time(r"gram_matvec_kernel|matvec_reduce_kernel")
    assert n == 7 and t == pytest.approx((3 * 205 + 100) * 1e-6)
    assert all(trace.PROGRAM_KERNEL.search(name) for name, _, _ in tr.kernels)
