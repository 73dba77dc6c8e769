"""Panelled Nyström builds per build: the program's ``lgt.nystrom.panels``
spans (``ops/linalg/pcg.py::nystrom_products``) inside its
``lgt.nystrom.build`` spans (``models/iterative.py::_preconditioner``), over
the builds.  At ranks 4,096 and 8,192 every build forms its two products in
column panels: 1.0.  Nothing where the trace holds no such span (a program
without the route)."""

from benchmark.harness.spans import count_inside


def read(rec):
    panels, builds = count_inside(rec.trace, "lgt.nystrom.panels", "lgt.nystrom.build")
    return panels / builds if panels and builds else None
