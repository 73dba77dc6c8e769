"""On the card: each cell's program spans read a finite value for every
quantity they were placed for, every device operation of the window has its
launch, and, once the drift of the device's clock is removed, none starts
before its launch by more than a launch's latency; the span metrics of the
manifest appear in a traced run's line.  Run on a machine with a card:

    python -m pytest benchmark/tests/test_bench_spans_card.py -q -o addopts=""
"""

import math

import pytest

from benchmark.harness import catalog, spans
from benchmark.tests.test_bench_card import run

#: What each cell's spans were placed to measure (``spans.report``).
QUANTITIES = {"heat.condition": ["nystrom_build_s", "nystrom_apply_ms", "cg_host_reads"],
              "heat.variance": ["block_cg_vector_ms"],
              "ibvp.condition": ["chol_aux_ms"],
              "ibvp.query": ["std_solve_ms", "gp_query.idle_ms"]}
SPAN_METRICS = [m for m in catalog.manifest()["per_layer"] if m["source"] == "program_span"]
#: How far before its launch an operation may read once the drift is
#: removed: the launch's own latency and the interpolation of the offset
#: between two synchronizations.
LAUNCH_SLACK_S = 20e-6


@pytest.mark.card
@pytest.mark.parametrize("cell", list(QUANTITIES))
def test_spans_charge_every_operation(cell, card):
    result, st = spans.run_and_read(cell, 2**32 + 19, 2.0)
    assert result["correct"], result["checks"]
    rep = spans.report(st, result["attempted"])
    for name in QUANTITIES[cell]:
        assert rep["metrics"][name] is not None and math.isfinite(rep["metrics"][name]), (name, rep)
    assert st.ops and st.unlaunched == 0
    assert st.earliest_start_before_launch() <= LAUNCH_SLACK_S, rep


@pytest.mark.card
@pytest.mark.parametrize("entry", SPAN_METRICS, ids=lambda m: m["name"])
def test_span_metric_in_the_traced_line(entry, card):
    for cell in entry["workloads"]:
        value = run(cell, 1)["metrics"][entry["name"]]["value"]
        assert math.isfinite(value), (cell, value)
