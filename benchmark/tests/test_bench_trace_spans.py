"""The program's spans on synthetic Chrome-trace events: a device operation is
charged to the innermost span open at its launch (found by correlation), not
to the span that holds its device interval; idle time inside spans is exact,
also once a drifting device clock has been moved onto the host's; the
program's spans leave every accepted reading of the trace as it was; and the
new reader reads nothing where its spans are absent."""

import pytest

from benchmark.harness import catalog, spans, trace
from benchmark.harness.runner import Record

MAN = catalog.manifest()
T0 = 1_000_000.0  # the window's start, us


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": T0 + ts, "dur": dur, "args": args}


def launch(corr, ts, name="cudaLaunchKernel"):
    return X(name, "cuda_runtime", ts, 4.0, correlation=corr)


def kernel(name, corr, ts, dur, cat="kernel"):
    return X(name, cat, ts, dur, correlation=corr, stream=7)


def window(dur):
    return X(trace.WINDOW_SPAN, "user_annotation", 0.0, dur)


def test_charged_to_the_span_open_at_launch():
    """k1 is launched in lgt.a.inner and k2 in lgt.a, but both run while the
    host is in lgt.b; k3 is launched outside every span."""
    ev = [window(1000.0),
          X("lgt.a", "user_annotation", 100, 100), X("lgt.a.inner", "user_annotation", 120, 30),
          X("lgt.b", "user_annotation", 300, 100),
          launch(1, 130), launch(2, 180), launch(3, 250, "cudaMemcpyAsync"),
          kernel("void lgt::gram_kernel<S>()", 1, 310, 20), kernel("sm90_xmma_gemm_f64", 2, 330, 30),
          kernel("Memcpy DtoD", 3, 360, 10, cat="gpu_memcpy")]
    st = spans.from_events(ev)
    got = {k: (round(t * 1e6, 6), n) for k, (t, n) in st.charged().items()}
    assert got == {"lgt.a.inner": (20.0, 1), "lgt.a": (30.0, 1), None: (10.0, 1)}
    assert st.charged("lgt.a", cats=("kernel",), pattern="gemm") == {"lgt.a": pytest.approx((30e-6, 1))}
    assert st.inside("lgt.a") == pytest.approx((50e-6, 2))
    assert st.inside("lgt.a", exclude=("lgt.a.inner",)) == pytest.approx((30e-6, 1))
    assert st.inside("lgt.b") == (0.0, 0)
    assert st.uncharged_share() == pytest.approx(10 / 60)
    assert st.count_inside("lgt.a.inner", "lgt.a") == 1 and st.count_inside("lgt.b", "lgt.a") == 0


def _idle_events(rate=0.0, step=0.0, steps=100, period=0.1):
    """``steps`` requests ``period`` s apart, each a span lgt.q of 400 us
    holding a launch that meets an idle device 2 us later and runs 100 us,
    then lgt.r of 300 us holding one of 50 us: 300 + 250 us idle in the
    spans, per request.  The device clock runs ``rate`` off the host's and
    steps by ``step`` us in the middle of the window."""
    ev, corr = [], 0
    for i in range(steps):
        t = i * period * 1e6
        for name, dur, k in (("lgt.q", 400.0, 100.0), ("lgt.r", 300.0, 50.0)):
            corr += 1
            ev += [X(name, "user_annotation", t + 10, dur), launch(corr, t + 10)]
            start = t + 12
            shift = rate * start + (step if i >= steps // 2 else 0.0)
            ev.append(kernel("void at::native::elementwise_kernel<E>()", corr, start + shift, k))
            t += 1000
    return [window(steps * period * 1e6)] + ev


@pytest.mark.parametrize("rate, step", [(0.0, 0.0), (-6e-3, 0.0), (6e-3, 0.0), (-1e-3, 5000.0), (0.0, -8000.0)])
def test_idle_within_exact_and_drift_removed(rate, step):
    st = spans.from_events(_idle_events(rate, step))
    if not step:
        assert st.drift_ppm == pytest.approx(rate * 1e6, abs=1.0)
    assert st.idle_within(["lgt.q", "lgt.r"]) == pytest.approx(100 * 550e-6, abs=100 * 1e-6)
    assert st.idle_within(["lgt.q"]) == pytest.approx(100 * 300e-6, abs=100 * 1e-6)
    assert abs(st.earliest_start_before_launch()) <= 1e-9
    raw = max(-o.lag for o in st.ops)
    assert raw > 0.004 if rate < 0 or step < 0 else raw < 0


def _base_events():
    """A window with the program's kernels, the library's, PyTorch's, a copy,
    host operators and the benchmark's spans."""
    ev = [window(10_000.0), X("bench.std", "user_annotation", 100, 6000), X("aten::mm", "cpu_op", 200, 50)]
    names = ["void lgt::gram_kernel<S>()", "void lgt::gram_matvec_kernel<S>()", "void lgt::gram_matmat_kernel<S>()",
             "sm90_xmma_gemm_f64f64", "kernel_trsm_l_mul32", "void at::native::elementwise_kernel<E>()",
             "void at::native::triu_tril_kernel<E>()"]
    for i, name in enumerate(names * 3):
        ts = 300 + 400 * i
        ev += [launch(i + 1, ts - 50), kernel(name, i + 1, ts, 150 + 10 * i)]
    ev += [launch(99, 9000, "cudaMemcpyAsync"), kernel("Memcpy DtoD", 99, 9100, 300, cat="gpu_memcpy")]
    return ev


def _program_spans():
    out = []
    for name, ts, dur in (("lgt.gp.var", 250, 5000), ("lgt.gp.var.solve", 1000, 2000), ("lgt.pcg", 6500, 3000),
                          ("lgt.host_read", 6600, 100), ("lgt.pcg.matvec", 7000, 400)):
        out += [X(name, "user_annotation", ts, dur), X(name, "gpu_user_annotation", ts + 60, dur)]
    return out


STEPS = {"heat.condition": [{"work": 1, "iters": 2, "n": 2000, "rank": 128, "queries": 64}],
         "heat.variance": [{"work": 256, "block_iters": [3], "n": 2000, "block_size": 256}],
         "ibvp.condition": [{"work": 1, "n": 2000, "cuts": [96, 48, 48], "queries": 64}],
         "ibvp.query": [{"work": 64}]}


def _record(cell, tr):
    wl = catalog.workload(cell)
    cfg = catalog.config(wl["config"])
    return Record(cell=cell, cfg=cfg, wl=wl, mode=cfg["mode"], setup_s=1.0, window_s=tr.window_s,
                  steps=STEPS[cell], trace=tr)


def test_program_spans_leave_the_accepted_readings_unchanged():
    base = trace.parse(_base_events())
    more = trace.parse(_base_events() + _program_spans())
    assert more.busy == base.busy and more.busy_s == base.busy_s and more.kernels == base.kernels
    for pattern in (r"\bgram_kernel", r"gram_matvec_kernel|matvec_reduce_kernel", r"gram_matmat_kernel"):
        assert more.kernel_time(pattern) == base.kernel_time(pattern)
    assert more.dense_library_time() == base.dense_library_time()
    assert more.top_kernels() == base.top_kernels()
    # The gaps are the same; those inside a program span are now named by it.
    assert [d for _, d in more.idle_gaps()] == [d for _, d in base.idle_gaps()]
    for cell in STEPS:
        for entry in catalog.cell_metrics(MAN, cell, True):
            if entry["source"] == "program_span":
                continue
            r = catalog.reader(entry["name"])
            assert r.read(_record(cell, more)) == r.read(_record(cell, base)), (cell, entry["name"])


@pytest.mark.parametrize("entry", [m for m in MAN["per_layer"] if m["source"] == "program_span"],
                         ids=lambda m: m["name"])
def test_span_reader_reads_nothing_without_its_spans(entry):
    for cell in entry["workloads"]:
        assert catalog.reader(entry["name"]).read(_record(cell, trace.parse(_base_events()))) is None


def test_cg_host_reads_counts_the_reads_inside_each_solve():
    ev = [window(10_000.0)]
    for t, its in ((100, 3), (5000, 4)):
        ev.append(X("lgt.pcg", "user_annotation", t, 4000))
        ev += [X("lgt.host_read", "user_annotation", t + 10 + 100 * k, 20) for k in range(its + 1)]
    ev.append(X("lgt.host_read", "user_annotation", 9500, 20))  # a blocked CG's, outside lgt.pcg
    steps = [{"work": 1, "iters": 3, "n": 2000, "rank": 128, "queries": 64},
             {"work": 1, "iters": 4, "n": 2000, "rank": 128, "queries": 64}]
    rec = _record("heat.condition", trace.parse(ev))
    rec.steps = steps
    assert catalog.reader("cg_host_reads").read(rec) == pytest.approx(9 / 7)
