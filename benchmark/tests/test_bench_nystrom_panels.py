"""``nystrom_panels_per_build`` on synthetic Chrome-trace events: the
panelled products' spans inside the Nyström builds, over the builds, and
nothing where the program marks no panelled build (a program without the
route, or a build below its rank)."""

import pytest

from benchmark.harness import catalog, trace
from benchmark.tests.test_bench_trace_spans import X, _record, window


def _events(panelled_builds, builds=3):
    ev = [window(10_000.0)]
    for k in range(builds):
        t = 100 + 3000 * k
        ev.append(X("lgt.nystrom.build", "user_annotation", t, 2000))
        if k < panelled_builds:
            ev.append(X("lgt.nystrom.panels", "user_annotation", t + 500, 1200))
    ev.append(X("lgt.nystrom.panels", "user_annotation", 9500, 100))  # outside every build
    return ev


@pytest.mark.parametrize("panelled,want", [(3, 1.0), (1, 1 / 3), (0, None)])
def test_nystrom_panels_per_build(panelled, want):
    rec = _record("heat.condition", trace.parse(_events(panelled)))
    got = catalog.reader("nystrom_panels_per_build").read(rec)
    assert got == (None if want is None else pytest.approx(want))
